"""Image-fidelity metrics of the port."""
