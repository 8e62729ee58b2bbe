"""Command-line interface of the port.

    python -m sradsgan_tpu_torch.cli train --model sradsgan --scale 4 \\
        --data synthetic [--model-kwargs '{"rab_tail": "fused"}'] [--lpips]
    python -m sradsgan_tpu_torch.cli chain-train --scales 2 3 4 8 9 ...
    python -m sradsgan_tpu_torch.cli validate --scale 4 \\
        --ckpt Result/SRADSGAN_x4/ckpt_best.pt [--lpips]
    python -m sradsgan_tpu_torch.cli validate-by-class --scale 4 \\
        --ckpt Result/SRADSGAN_x4/ckpt_best.pt [--lpips] [--save-img]
    python -m sradsgan_tpu_torch.cli infer --model sradsgan --scale 4 \\
        --image scene.tif --ckpt Result/SRADSGAN_x4/ckpt_best.pt
    python -m sradsgan_tpu_torch.cli export --model sradsgan --scale 4 \
        --lr-size 54 --out m.pt2 [--ckpt ...] [--device cpu]
    python -m sradsgan_tpu_torch.cli list-models
    python -m sradsgan_tpu_torch.cli diffusion-train \
        --gdp-config gdp_train_54_216 --data synthetic --n-iter 1000
    python -m sradsgan_tpu_torch.cli diffusion-validate \
        --gdp-config gdp_train_54_216 --ckpt Result/GDP/gdp_ckpt_latest.pt
    python -m sradsgan_tpu_torch.cli diffusion-sample --scale 4 \
        --image scene.png --ckpt Result/GDP/gdp_ckpt_latest.pt

Each command takes the flags of its ``python -m sradsgan_tpu.cli``
counterpart, so a JAX command line parses unchanged, plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).  ``--model``
is any model ``list-models`` prints (the JAX package's nine), with its
recipe from ``models.config_for_model``.

``train`` archives a stale run directory (unless ``--resume``), builds the
``Trainer``, runs its epoch loop (``--steps`` stops after N steps instead),
prints the final metrics and the data feed's share of the last epoch as one
JSON line, and then, unless ``--no-final-eval``, the by-class table of the
trained generator as every reference ``main_*.py`` does (LPIPS columns with
``--lpips``, SR pngs and panels under ``<model_dir>/eval`` with
``--save-img``), the generator in float32 as the reference evaluates it
(the JAX command evaluates in the trainer's precision, bf16 by default).
``chain-train`` trains each of ``--scales`` in turn, each scale's generator
and discriminator warm-started from the previous scale's ``ckpt_best.pt``
(else its last epoch's checkpoint).

``validate``, ``validate-by-class``, ``infer`` and ``export`` load the
generator from
``--ckpt`` (a checkpoint ``train`` wrote, ``ckpt_epoch_N.pt`` or
``ckpt_best.pt``: its ``"generator"`` state dict) or ``--weights`` (the
JAX generator of ``--model`` as ``.npz``, see ``tools/from_jax.py``), not
both; with
neither it keeps its seeded random init, as the JAX CLI does without
``--ckpt``.  ``validate`` prints the whole test set's means as JSON,
``validate-by-class`` the per-class table, whose CSV it writes to
``<model_dir>/by_class_x<scale>.csv``.  ``infer`` runs
``evaluation.validate.mfe_test_single``: the image, centre-cropped by
``--test-crop``, goes through the generator as it is, and the SR png, the
bicubic png and, where matplotlib imports, the panel are written.
``export`` writes the generator as a ``torch.export`` program traced at
batch 1 of ``--lr-size``^2 (``serving.export_model``; the weights inside,
float32, on ``--device``), which ``serving.load_exported`` reads back.
Without the LPIPS trunk's weights (``SRADSGAN_TPU_ALEXNET_NPZ``)
``--lpips`` says that it reports the uncalibrated ``lpips*``.

The ``diffusion-*`` commands drive ``diffusion.trainer.DiffusionTrainer``
(GDP's conditional DDPM), built from ``--gdp-config`` (a bundled GDP config
by name, or a path; ``--unet-kwargs`` then replaces its UNet arguments
whole, as in JAX) or from ``--scale``, ``--timesteps`` and
``--unet-kwargs``; the data flags are the common ones.  ``--weights``
starts the UNet from the JAX UNet's params as ``.npz``
(``tools/from_jax.py:unet_state_dict``); ``--ckpt`` (``diffusion-sample``,
``diffusion-validate``) restores a checkpoint ``diffusion-train`` wrote,
weights, Adam state and step; not both.  ``diffusion-train`` runs
``--n-iter`` steps and saves ``<save_dir>/GDP/gdp_ckpt_latest.pt``;
``diffusion-validate`` samples the first ``--max-images`` test images and
prints the metrics against the bicubic twin, with the dumps under
``--result-dir`` (``--continuous``: the reverse chain's snapshots too);
``diffusion-sample`` reads one image (a png or tif through Pillow, or an
HWC uint8 ``.npy``), upsamples it bicubically by the scale (Pillow's
``resize`` as the JAX command does; for an ``.npy`` the port's copy of it,
``ops/resize.py``, which may differ by one level on a few pixels, so that
no Pillow is needed), samples the SR and writes it as a png, or as
``.npy`` where Pillow does not import.

``train``, ``chain-train`` and ``diffusion-train`` train data-parallel
under ``torchrun --nproc_per_node=N python -m sradsgan_tpu_torch.cli ...``:
one process a device, NCCL on the card (gloo with ``--device cpu``),
``--batch-size`` the global batch (``parallel/mesh.py``).  Rank 0 alone
archives the run directory, writes, prints the result line and, after
``train``, the by-class table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's common flags.  ``infer`` reads --model, --scale and
    --model-kwargs and accepts the rest only so that a JAX command line
    parses; the other commands read them all."""
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
                   help="LPIPS columns in the evaluation (see losses/lpips.py "
                        "about the trunk's weights); train's own sweep "
                        "never reads it")
    p.add_argument("--config", help="JSON TrainConfig overriding flags")


def _lpips(args):
    if not args.lpips:
        return None
    from sradsgan_tpu_torch.losses.lpips import lpips_fn, lpips_is_calibrated

    if not lpips_is_calibrated():
        print("note: LPIPS backbone weights not provided "
              "(SRADSGAN_TPU_ALEXNET_NPZ); reporting uncalibrated lpips*")
    return lpips_fn()


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


def _load_eval_model(args):
    """The generator of ``--model``/``--scale``/``--model-kwargs`` on the
    CPU, holding ``--ckpt`` (the port's ``.pt``) or ``--weights`` (the JAX
    generator's params, or for SRGAN and SRAGAN its variables with
    ``batch_stats``, as ``.npz``; ``tools/from_jax.py:generator_state_dict``
    maps them by ``--model``), else its seeded init."""
    import torch

    from sradsgan_tpu_torch.models import create_generator
    from sradsgan_tpu_torch.tools.from_jax import (generator_state_dict,
                                                   load_npz)

    if args.ckpt and args.weights:
        raise SystemExit(f"{args.cmd}: pass --ckpt (a checkpoint of cli "
                         "train) or --weights (JAX generator params), not "
                         "both")
    kwargs = json.loads(args.model_kwargs) if args.model_kwargs else {}
    model = create_generator(args.model, args.scale, **kwargs)
    if args.ckpt:
        state = torch.load(args.ckpt, map_location="cpu", weights_only=True)
        model.load_state_dict(state["generator"])
    elif args.weights:
        model.load_state_dict(generator_state_dict(args.model,
                                                   load_npz(args.weights)))
    return model


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


def _launched_rank() -> int:
    """This process's rank under a launcher (0 without one)."""
    return int(os.environ.get("RANK", "0"))


def cmd_train(args) -> int:
    from sradsgan_tpu_torch.train.trainer import Trainer

    cfg = _build_cfg(args)
    if args.epochs is not None:
        cfg.num_epochs = args.epochs
    if args.init_from:
        cfg.init_from = args.init_from
    if not args.resume and _launched_rank() == 0:
        _archive_stale_dir(cfg.model_dir)  # the other ranks wait in Trainer
    trainer = Trainer(cfg, device=args.device)
    if args.resume:
        trainer.load_checkpoint(args.resume)
    metrics = trainer.train(num_steps=args.steps)
    if not trainer.mesh.is_main:
        return 0
    feed = dict(trainer.feed_stats)
    if feed.get("epoch_s"):
        feed["feed_share"] = feed["feed_wait_s"] / feed["epoch_s"]
    # the steps taken eagerly, captured into a CUDA graph and replayed
    print(json.dumps({"final": metrics, "feed": feed,
                      "steps": trainer.graph_stats}))
    if not args.no_final_eval:
        from sradsgan_tpu_torch.evaluation.validate import (
            format_by_class_table, mfe_new_validate_by_class)
        table = mfe_new_validate_by_class(
            trainer.generator, cfg.data, cfg.scale, lpips_fn=_lpips(args),
            save_img=args.save_img,
            save_dir=os.path.join(cfg.model_dir, "eval"),
            device=args.device)
        print(format_by_class_table(table))
    return 0


def cmd_chain_train(args) -> int:
    from sradsgan_tpu_torch.train.trainer import Trainer

    prev_ckpt = None
    results = {}
    for scale in args.scales:
        args.scale = scale
        cfg = _build_cfg(args)
        if args.epochs is not None:
            cfg.num_epochs = args.epochs
        cfg.init_from = prev_ckpt
        trainer = Trainer(cfg, device=args.device)
        results[f"x{scale}"] = trainer.train(num_steps=args.steps)
        prev_ckpt = trainer.save_checkpoint(cfg.num_epochs - 1)
        best = os.path.join(cfg.model_dir, "ckpt_best.pt")
        if os.path.exists(best):
            prev_ckpt = best
        if trainer.mesh.is_main:
            print(f"scale x{scale} done; next init_from={prev_ckpt}")
    if trainer.mesh.is_main:
        print(json.dumps({k: {m: float(v) for m, v in r.items()}
                          for k, r in results.items()}))
    return 0


def cmd_validate(args) -> int:
    from sradsgan_tpu_torch.evaluation.validate import mfe_new_validate

    cfg = _build_cfg(args)
    out = mfe_new_validate(_load_eval_model(args), cfg.data, args.scale,
                           lpips_fn=_lpips(args), save_img=args.save_img,
                           save_dir=os.path.join(cfg.model_dir, "eval"),
                           device=args.device)
    print(json.dumps(out, indent=2))
    return 0


def cmd_validate_by_class(args) -> int:
    from sradsgan_tpu_torch.evaluation.validate import (
        format_by_class_table, mfe_new_validate_by_class, save_by_class_csv)

    cfg = _build_cfg(args)
    table = mfe_new_validate_by_class(
        _load_eval_model(args), cfg.data, args.scale, lpips_fn=_lpips(args),
        save_img=args.save_img,
        save_dir=os.path.join(cfg.model_dir, "eval"), device=args.device)
    print(format_by_class_table(table))
    csv_path = os.path.join(cfg.model_dir, f"by_class_x{args.scale}.csv")
    save_by_class_csv(table, csv_path)
    print(f"table saved: {csv_path}")
    return 0


def cmd_infer(args) -> int:
    from sradsgan_tpu_torch.evaluation.validate import mfe_test_single

    out = mfe_test_single(_load_eval_model(args), args.image, args.scale,
                          args.out_dir, crop_size=args.test_crop,
                          device=args.device)
    print(json.dumps(out))
    return 0


def cmd_export(args) -> int:
    from sradsgan_tpu_torch.serving import export_model

    path = export_model(_load_eval_model(args), args.lr_size, args.out,
                        device=args.device)
    print(json.dumps({"exported": path}))
    return 0


def _build_diffusion_trainer(args):
    """The ``DiffusionTrainer`` of the diffusion flags, holding ``--ckpt``
    or ``--weights`` where given."""
    from sradsgan_tpu_torch.diffusion.trainer import DiffusionTrainer

    ckpt = getattr(args, "ckpt", None)
    if ckpt and args.weights:
        raise SystemExit(f"{args.cmd}: pass --ckpt (a checkpoint of "
                         "diffusion-train) or --weights (JAX UNet params), "
                         "not both")
    cfg = _build_cfg(args)
    unet_kwargs = json.loads(args.unet_kwargs) if args.unet_kwargs else None
    common = dict(save_dir=os.path.join(args.save_dir, "GDP"),
                  bf16=not args.no_bf16, device=args.device)
    if args.gdp_config:
        trainer = DiffusionTrainer.from_gdp_config(
            args.gdp_config, cfg.data, **common,
            **({"unet_kwargs": unet_kwargs} if unet_kwargs else {}))
    else:
        trainer = DiffusionTrainer(cfg.data, args.scale,
                                   n_timestep=args.timesteps,
                                   unet_kwargs=unet_kwargs, **common)
    if ckpt:
        trainer.load_checkpoint(ckpt)
    elif args.weights:
        from sradsgan_tpu_torch.tools.from_jax import load_npz, unet_state_dict
        unet = trainer.unet
        trainer.unet.load_state_dict(unet_state_dict(
            load_npz(args.weights), unet.channel_mults, unet.attn_res,
            unet.res_blocks, unet.resblock_updown))
    return trainer


def cmd_diffusion_train(args) -> int:
    trainer = _build_diffusion_trainer(args)
    loss = trainer.train(args.n_iter, val_freq=args.val_freq)
    path = trainer.save_checkpoint()
    if trainer.mesh.is_main:
        print(json.dumps({"final_loss": loss, "ckpt": path}))
    return 0


def cmd_diffusion_validate(args) -> int:
    trainer = _build_diffusion_trainer(args)
    val = trainer.validate(max_images=args.max_images,
                           result_dir=args.result_dir,
                           continuous=args.continuous)
    print(json.dumps({"result_dir": args.result_dir, **val}))
    return 0


def _bicubic_u8(path: str, scale: int):
    """An image upsampled bicubically by ``scale``, as HWC float32 in
    [0, 255]: an ``.npy`` of HWC uint8 through the port's 8-bit resize,
    anything else opened and resized by Pillow, as the JAX command does."""
    import numpy as np

    if path.endswith(".npy"):
        import torch

        from sradsgan_tpu_torch.ops.resize import resize_uint8

        arr = np.load(path)
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
            raise SystemExit(f"{path}: want an HWC uint8 RGB array, got "
                             f"{arr.dtype} {arr.shape}")
        h, w = arr.shape[:2]
        return resize_uint8(torch.from_numpy(arr.astype(np.float32)),
                            h * scale, w * scale, "bicubic").numpy()
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img.resize((img.width * scale, img.height * scale),
                                 Image.BICUBIC), np.float32)


def cmd_diffusion_sample(args) -> int:
    import numpy as np

    from sradsgan_tpu_torch.utils.plotting import save_image

    trainer = _build_diffusion_trainer(args)
    scale = trainer.scale  # --gdp-config's where given
    bc = _bicubic_u8(args.image, scale)
    sr = trainer.super_resolution(bc[None] / 255.0)[0]
    name = os.path.splitext(os.path.basename(args.image))[0]
    out = os.path.join(args.out_dir, f"GDP_SR_{name}_x{scale}.png")
    try:
        save_image(sr, out)
    except ImportError:
        out = out[:-len(".png")] + ".npy"
        os.makedirs(args.out_dir, exist_ok=True)
        np.save(out, np.clip(sr, 0, 1))
        print(f"diffusion-sample: Pillow does not import here; the SR is "
              f"written as float [0, 1] HWC to {out}", file=sys.stderr)
    print(json.dumps({"sr": out}))
    return 0


def cmd_list_models(_args) -> int:
    from sradsgan_tpu_torch.models import available_models, get_spec

    for name in available_models():
        spec = get_spec(name)
        kind = f"GAN({spec.gan_type})" if spec.adversarial else "pixel"
        print(f"{name:<10} {kind}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="sradsgan_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_eval_model(p):
        p.add_argument("--ckpt", help="a checkpoint cli train wrote "
                       "(ckpt_epoch_N.pt, ckpt_best.pt)")
        p.add_argument("--weights",
                       help="the JAX generator's params (with batch_stats "
                            "where it has BatchNorm) as .npz "
                            "(tools/from_jax.py)")

    p = sub.add_parser("train", help="train a model (then eval by class)")
    _add_common(p)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="stop after N optimizer steps (smoke runs)")
    p.add_argument("--init-from", help="chain-training checkpoint")
    p.add_argument("--resume", help="resume from a checkpoint path")
    p.add_argument("--save-img", action="store_true")
    p.add_argument("--no-final-eval", action="store_true")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser(
        "chain-train",
        help="paper protocol: train x2 -> x3 -> x4 -> x8 -> x9, each scale "
             "warm-started from the previous best checkpoint")
    _add_common(p)
    p.add_argument("--scales", type=int, nargs="+", default=[2, 3, 4, 8, 9])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_chain_train)

    p = sub.add_parser("validate", help="mfeNew_validate protocol")
    _add_common(p)
    add_eval_model(p)
    p.add_argument("--save-img", action="store_true")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("validate-by-class",
                       help="mfeNew_validateByClass protocol (paper tables)")
    _add_common(p)
    add_eval_model(p)
    p.add_argument("--save-img", action="store_true")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_validate_by_class)

    p = sub.add_parser("infer", help="single-image SR (mfe_test_single)")
    _add_common(p)
    add_eval_model(p)
    p.add_argument("--image", required=True)
    p.add_argument("--out-dir", default="Result/single")
    p.add_argument("--test-crop", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("export", help="export a model (torch.export, .pt2)")
    _add_common(p)
    add_eval_model(p)
    p.add_argument("--lr-size", type=int, default=54)
    p.add_argument("--out", default="exported_model.pt2")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_export)

    def add_diffusion(p):
        p.add_argument("--timesteps", type=int, default=1000)
        p.add_argument("--gdp-config",
                       help="bundled or custom GDP JSON config name/path "
                            "(e.g. gdp_train_54_216)")
        p.add_argument("--unet-kwargs", default=None,
                       help='JSON UNet-constructor overrides, e.g. '
                            '\'{"inner_channel": 32}\'')
        p.add_argument("--weights",
                       help="the JAX UNet's params as .npz "
                            "(tools/from_jax.py)")
        p.add_argument("--device", default="cuda")

    p = sub.add_parser("diffusion-train",
                       help="GDP-style conditional diffusion SR training")
    _add_common(p)
    add_diffusion(p)
    p.add_argument("--n-iter", type=int, default=1000000)
    p.add_argument("--val-freq", type=int, default=0)
    p.set_defaults(fn=cmd_diffusion_train)

    p = sub.add_parser("diffusion-sample",
                       help="sample SR from a trained diffusion model")
    _add_common(p)
    add_diffusion(p)
    p.add_argument("--image", required=True)
    p.add_argument("--ckpt", help="a checkpoint diffusion-train wrote")
    p.add_argument("--out-dir", default="Result/GDP/samples")
    p.set_defaults(fn=cmd_diffusion_sample)

    p = sub.add_parser("diffusion-validate",
                       help="diffusion eval sweep with tif/panel dumps "
                            "(reference sr_mfe.py -p val)")
    _add_common(p)
    add_diffusion(p)
    p.add_argument("--ckpt", help="a checkpoint diffusion-train wrote")
    p.add_argument("--max-images", type=int, default=4)
    p.add_argument("--result-dir", default="Result/GDP/val")
    p.add_argument("--continuous", action="store_true",
                   help="continuous sampling: save reverse-chain grids")
    p.set_defaults(fn=cmd_diffusion_validate)

    p = sub.add_parser("list-models")
    p.set_defaults(fn=cmd_list_models)

    args = parser.parse_args(argv)
    code = args.fn(args)
    import torch.distributed as dist

    if dist.is_initialized():  # a data mesh's group, under torchrun
        dist.destroy_process_group()
    return code


if __name__ == "__main__":
    sys.exit(main())
