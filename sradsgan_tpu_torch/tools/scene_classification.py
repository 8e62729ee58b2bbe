"""Downstream scene classification of SR outputs: land-use accuracy as a
measure of SR quality.

Counterpart of ``sradsgan_tpu/tools/scene_classification.py`` (the
reference's Scene_classification_mfe.py): a per-class 65/10/25 split of a
UCMerced-style tree (:func:`split_dataset`), frozen VGG16 bottleneck
features, a Dense(256) -> ReLU -> Dense(K) head trained on the HR training
split, and the accuracy and confusion matrix of that head on an SR output
tree (:meth:`SceneClassifier.evaluate_folder`).

The trunk is ``losses/lpips.py:VGG16Features`` (the conv stack of Keras
``VGG16(include_top=False)``): relu5_3, a 2x2/2 max pool (Keras
``block5_pool``), flattened in (H, W, C) order as Keras and the JAX package
flatten; at 216^2 that is 6 x 6 x 512 = 18 432 features.  It is LPIPS's
VGG16 trunk (``losses/lpips.py:load_lpips("vgg")``): the weights of the
file that ``SRADSGAN_TPU_VGG16_NPZ`` names (the JAX package's ``.npz``
layout, or torchvision's ``.pth``) where it exists, otherwise a seeded
trunk, a self-consistent downstream metric whose absolute accuracies
differ from the Keras-VGG16 numbers.  ``pretrained`` says which.

Images are read and resized with PIL (imported in the call) on the host;
features and the head run on ``device``, the card unless the caller asks
for the CPU.

    python -m sradsgan_tpu_torch.tools.scene_classification \\
        --hr-root UCMerced/HR --sr-root results/SR --out scene.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sradsgan_tpu_torch.data.datasets import scan_class_dirs, scan_image_dirs
from sradsgan_tpu_torch.losses.lpips import load_lpips
from sradsgan_tpu_torch.tools import require_cuda

HIDDEN = 256


def split_dataset(root: str, train_frac: float = 0.65,
                  val_frac: float = 0.10, seed: int = 0):
    """Per-class train/val/test split of a class-folder tree: each class's
    files permuted by one ``np.random.default_rng(seed)`` shared over the
    classes in sorted order, the first ``int(n * train_frac)`` to train, the
    next ``int(n * val_frac)`` to val, the rest to test.  Returns
    ``({"train": [(file, label), ...], "val": ..., "test": ...},
    class_names)``."""
    rng = np.random.default_rng(seed)
    splits = {"train": [], "val": [], "test": []}
    classes = []
    for label, (name, path) in enumerate(scan_class_dirs(root)):
        classes.append(name)
        files = scan_image_dirs([path])
        idx = rng.permutation(len(files))
        n_train = int(len(files) * train_frac)
        n_val = int(len(files) * val_frac)
        for j in idx[:n_train]:
            splits["train"].append((files[j], label))
        for j in idx[n_train:n_train + n_val]:
            splits["val"].append((files[j], label))
        for j in idx[n_train + n_val:]:
            splits["test"].append((files[j], label))
    return splits, classes


class SceneClassifier:
    """A frozen VGG16 trunk and a trainable two-layer head on ``device``."""

    def __init__(self, image_size: int = 216, feature_batch: int = 32,
                 seed: int = 0, device: torch.device | str = "cuda"):
        require_cuda(device, "SceneClassifier")
        self.device = torch.device(device)
        self.image_size = image_size
        self.feature_batch = feature_batch
        self.seed = seed
        lpips, self.pretrained = load_lpips("vgg", self.device)
        self.trunk = lpips.net
        self.head: Optional[Dict[str, torch.Tensor]] = None
        self.classes: List[str] = []

    # ------------------------------------------------------------------
    def bottleneck(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) images in [0, 1] -> (B, dim) features: relu5_3,
        2x2/2 max pool, flattened in (H, W, C) order."""
        pooled = F.max_pool2d(self.trunk(x)[-1], 2, 2)
        return pooled.permute(0, 2, 3, 1).reshape(pooled.shape[0], -1)

    @torch.no_grad()
    def features(self, files: List[str]) -> np.ndarray:
        """(n, dim) float32 features of the files, each read as RGB and
        resized with PIL BICUBIC to ``image_size`` on the host,
        ``feature_batch`` at a time on the device."""
        from PIL import Image

        size = (self.image_size, self.image_size)
        feats = []
        for i in range(0, len(files), self.feature_batch):
            imgs = torch.from_numpy(np.stack([np.asarray(
                Image.open(f).convert("RGB").resize(size, Image.BICUBIC),
                np.float32) / 255.0 for f in files[i:i + self.feature_batch]
            ])).to(self.device)
            feats.append(self.bottleneck(imgs.permute(0, 3, 1, 2))
                         .float().cpu().numpy())
        return np.concatenate(feats) if feats else np.zeros((0, HIDDEN))

    # ------------------------------------------------------------------
    def init_head(self, dim: int, num_classes: int
                  ) -> Dict[str, torch.Tensor]:
        """The head's initial weights, the JAX package's law: w1 normal(0,
        1 / sqrt(dim)), w2 normal(0, 0.0625), zero biases, drawn on the CPU
        from ``torch.Generator().manual_seed(seed)``."""
        gen = torch.Generator().manual_seed(self.seed)
        return {"w1": torch.randn((dim, HIDDEN), generator=gen) / dim ** 0.5,
                "b1": torch.zeros(HIDDEN),
                "w2": torch.randn((HIDDEN, num_classes), generator=gen)
                * 0.0625,
                "b2": torch.zeros(num_classes)}

    @staticmethod
    def _logits_of(head: Dict[str, torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ head["w1"] + head["b1"])
        return h @ head["w2"] + head["b2"]

    def fit_head(self, x: np.ndarray, y: np.ndarray, num_classes: int,
                 epochs: int = 50, lr: float = 1e-3,
                 head: Optional[Dict[str, np.ndarray]] = None) -> float:
        """``epochs`` full-batch Adam steps of the mean softmax
        cross-entropy on features ``x`` and integer labels ``y``, from
        ``head`` (else :meth:`init_head`); the head is kept in
        ``self.head``.  Returns the loss of the last step, taken before its
        update."""
        start = head if head is not None else self.init_head(x.shape[-1],
                                                             num_classes)
        params = {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                               device=self.device, requires_grad=True)
                  for k, v in start.items()}
        # optax.adam's update: betas (0.9, 0.999), eps 1e-8 added outside
        # the square root of the second moment
        opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999),
                               eps=1e-8)
        xt = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        yt = torch.as_tensor(y, dtype=torch.long, device=self.device)
        loss = torch.tensor(float("nan"))
        for _ in range(epochs):
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(self._logits_of(params, xt), yt)
            loss.backward()
            opt.step()
        self.head = {k: v.detach() for k, v in params.items()}
        return float(loss.detach())

    @torch.no_grad()
    def logits(self, feats: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        return self._logits_of(self.head, x).cpu().numpy()

    def train_head(self, root: str, num_classes: Optional[int] = None,
                   epochs: int = 50, lr: float = 1e-3,
                   head: Optional[Dict[str, np.ndarray]] = None
                   ) -> Dict[str, float]:
        """Fit the head on the features of ``root``'s training split
        (:func:`split_dataset`); returns the last training loss and the
        accuracy on the val split."""
        splits, self.classes = split_dataset(root)
        num_classes = num_classes or len(self.classes)

        def feats_labels(split):
            files = [f for f, _ in splits[split]]
            labels = np.array([label for _, label in splits[split]],
                              np.int32)
            return self.features(files), labels

        x_train, y_train = feats_labels("train")
        x_val, y_val = feats_labels("val")
        loss = self.fit_head(x_train, y_train, num_classes, epochs, lr, head)
        val_acc = (float(np.mean(np.argmax(self.logits(x_val), -1) == y_val))
                   if len(y_val) else float("nan"))
        return {"train_loss": loss, "val_acc": val_acc}

    # ------------------------------------------------------------------
    def evaluate_folder(self, sr_root: str,
                        save_confusion: Optional[str] = None):
        """Accuracy and confusion matrix (rows true, columns predicted) of
        the trained head over a class-folder tree of SR outputs; the matrix
        also drawn to ``save_confusion`` where matplotlib imports."""
        if self.head is None:
            raise RuntimeError("call train_head first")
        y_true, y_pred = [], []
        for label, (_, path) in enumerate(scan_class_dirs(sr_root)):
            files = scan_image_dirs([path])
            if not files:
                continue
            preds = np.argmax(self.logits(self.features(files)), -1)
            y_true.extend([label] * len(files))
            y_pred.extend(preds.tolist())
        y_true = np.asarray(y_true)
        y_pred = np.asarray(y_pred)
        acc = float(np.mean(y_true == y_pred)) if len(y_true) else float("nan")
        n = int(max(y_true.max(), y_pred.max())) + 1 if len(y_true) else 0
        cm = np.zeros((n, n), np.int32)
        for t, p in zip(y_true, y_pred):
            cm[t, p] += 1
        if save_confusion and n:
            _plot_confusion(cm, acc, save_confusion)
        return {"accuracy": acc, "confusion": cm.tolist()}


def _plot_confusion(cm: np.ndarray, acc: float, path: str) -> None:
    try:
        import matplotlib
    except ImportError:
        print(f"scene_classification: matplotlib does not import here; "
              f"{path} not drawn", file=sys.stderr)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 7))
    ax.imshow(cm, cmap="Blues")
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    ax.set_title(f"accuracy {acc:.4f}")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="scene_classification",
        description="Scene-classification eval of SR outputs")
    parser.add_argument("--hr-root", required=True,
                        help="UCMerced-style HR root (class subdirs)")
    parser.add_argument("--sr-root", required=True,
                        help="SR output root (class subdirs)")
    parser.add_argument("--out", default="scene_classification.json")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    clf = SceneClassifier(device=args.device)
    head = clf.train_head(args.hr_root)
    result = clf.evaluate_folder(
        args.sr_root, save_confusion=args.out.replace(".json", ".png"))
    out = {"head": head, "sr_accuracy": result["accuracy"],
           "pretrained_trunk": clf.pretrained}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
