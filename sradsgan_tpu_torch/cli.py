"""Command-line interface of the port.

    python -m sradsgan_tpu_torch.cli train --model sradsgan --scale 4 \\
        --data synthetic --no-final-eval [--model-kwargs '{"rab_tail": "fused"}']
    python -m sradsgan_tpu_torch.cli infer --model sradsgan --scale 4 \\
        --image scene.tif --ckpt Result/SRADSGAN_x4/ckpt_best.pt
    python -m sradsgan_tpu_torch.cli list-models

``train`` takes the flags of ``python -m sradsgan_tpu.cli train`` plus
``--device``: it archives a stale run directory (unless ``--resume``),
builds the ``Trainer``, runs its epoch loop (``--steps`` stops after N
steps instead) and prints the final metrics and the data feed's share of
the last epoch as one JSON line.  The by-class evaluation that the JAX
command runs after training is not ported yet, so ``train`` asks for
``--no-final-eval`` and says so before any training starts; ``--lpips``,
which in JAX only adds LPIPS to that table, is accepted and read by
nothing.

``infer`` takes the flags of ``python -m sradsgan_tpu.cli infer``, so a JAX
command line parses unchanged, plus ``--weights`` (JAX generator params as
``.npz``, see ``tools/from_jax.py``) and ``--device``.  ``--ckpt`` names a
checkpoint that ``train`` wrote (``ckpt_epoch_N.pt`` or ``ckpt_best.pt``:
its ``"generator"`` state dict); with neither the generator keeps its
seeded random init, as the JAX CLI does without ``--ckpt``.  It runs
``evaluation.validate.mfe_test_single``: the image, centre-cropped by
``--test-crop``, goes through the generator as it is, and the SR png, the
bicubic png and, where matplotlib imports, the panel are written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's common flags.  ``infer`` reads --model, --scale and
    --model-kwargs and accepts the rest only so that a JAX command line
    parses; ``train`` reads them all."""
    p.add_argument("--model", default="sradsgan")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--test-dataset", default="UCMerced_LandUse")
    p.add_argument("--data", choices=["folder", "synthetic"],
                   default="folder")
    p.add_argument("--crop-size", type=int, default=216)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--save-dir", default="Result")
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--model-kwargs", default=None,
                   help='JSON generator-constructor overrides, e.g. '
                        '\'{"base_filters": 16}\'')
    p.add_argument("--lpips", action="store_true",
                   help="LPIPS in the final by-class table (not ported); "
                        "the training itself never reads it")
    p.add_argument("--config", help="JSON TrainConfig overriding flags")


def _build_cfg(args):
    from sradsgan_tpu_torch.config import load_config
    from sradsgan_tpu_torch.models import config_for_model

    if args.config:
        return load_config(args.config)
    cfg = config_for_model(args.model, args.scale)
    cfg.data.data_dir = args.data_dir
    cfg.data.test_dataset = args.test_dataset
    cfg.data.synthetic = args.data == "synthetic"
    cfg.data.crop_size = args.crop_size
    cfg.data.test_crop_size = args.crop_size
    cfg.data.batch_size = args.batch_size
    cfg.save_dir = args.save_dir
    cfg.bf16 = not args.no_bf16
    if args.model_kwargs:
        cfg.model_kwargs = json.loads(args.model_kwargs)
    return cfg


def _archive_stale_dir(path: str) -> None:
    """Rename an existing run dir to ``{path}_archived_{timestamp}``, so
    that a fresh run never mixes its outputs with a stale one's."""
    if os.path.isdir(path) and os.listdir(path):
        import datetime
        stamp = datetime.datetime.now().strftime("%y%m%d-%H%M%S")
        new_name = f"{path}_archived_{stamp}"
        print(f"run dir exists, renaming it to [{new_name}]",
              file=sys.stderr)
        os.rename(path, new_name)


def cmd_train(args) -> int:
    if not args.no_final_eval:
        raise SystemExit(
            "train: the final by-class evaluation (evaluation/validate.py) "
            "is not ported to PyTorch yet; pass --no-final-eval (nothing "
            "was trained)")
    from sradsgan_tpu_torch.train.trainer import Trainer

    cfg = _build_cfg(args)
    if args.epochs is not None:
        cfg.num_epochs = args.epochs
    if args.init_from:
        cfg.init_from = args.init_from
    if not args.resume:
        _archive_stale_dir(cfg.model_dir)
    trainer = Trainer(cfg, device=args.device)
    if args.resume:
        trainer.load_checkpoint(args.resume)
    metrics = trainer.train(num_steps=args.steps)
    feed = dict(trainer.feed_stats)
    if feed.get("epoch_s"):
        feed["feed_share"] = feed["feed_wait_s"] / feed["epoch_s"]
    print(json.dumps({"final": metrics, "feed": feed}))
    return 0


def cmd_infer(args) -> int:
    import torch

    from sradsgan_tpu_torch.evaluation.validate import mfe_test_single
    from sradsgan_tpu_torch.models import create_generator
    from sradsgan_tpu_torch.tools.from_jax import (load_npz,
                                                   sradsgan_state_dict)

    if args.ckpt and args.weights:
        raise SystemExit("infer: pass --ckpt (a checkpoint of cli train) or "
                         "--weights (JAX generator params), not both")
    kwargs = json.loads(args.model_kwargs) if args.model_kwargs else {}
    model = create_generator(args.model, args.scale, **kwargs)
    if args.ckpt:
        state = torch.load(args.ckpt, map_location="cpu", weights_only=True)
        model.load_state_dict(state["generator"])
    elif args.weights:
        model.load_state_dict(sradsgan_state_dict(load_npz(args.weights)))
    out = mfe_test_single(model, args.image, args.scale, args.out_dir,
                          crop_size=args.test_crop, device=args.device)
    print(json.dumps(out))
    return 0


def cmd_list_models(_args) -> int:
    from sradsgan_tpu_torch.models import available_models

    for name in available_models():
        print(name)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="sradsgan_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a model")
    _add_common(p)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="stop after N optimizer steps (smoke runs)")
    p.add_argument("--init-from", help="chain-training checkpoint")
    p.add_argument("--resume", help="resume from a checkpoint path")
    p.add_argument("--no-final-eval", action="store_true")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("infer", help="single-image SR (mfe_test_single)")
    _add_common(p)
    p.add_argument("--image", required=True)
    p.add_argument("--ckpt", help="a checkpoint cli train wrote "
                   "(ckpt_epoch_N.pt, ckpt_best.pt)")
    p.add_argument("--out-dir", default="Result/single")
    p.add_argument("--test-crop", type=int, default=None)
    p.add_argument("--weights",
                   help="JAX generator params as .npz (tools/from_jax.py)")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("list-models")
    p.set_defaults(fn=cmd_list_models)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
