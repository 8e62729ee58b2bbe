"""Host-side data feed of the port: datasets and the prefetching loader."""
