"""Offline dataset preparation on the host: GDP triplet folders, GDP LMDB
records and per-class LR folders.

Counterpart of ``sradsgan_tpu/tools/prepare_data.py`` (the reference's
GDP_x0/data/prepare_data.py and model/util.py folder builders); it writes
the same files, byte for byte.  PIL runs on a thread pool (the work is
decode- and encode-bound) and is imported inside the calls; ``lmdb`` only
by :func:`prepare_lmdb`.

    python -m sradsgan_tpu_torch.tools.prepare_data triplets --src DIR \\
        --dst DIR [--hr-size 216] [--lr-size 54]
    python -m sradsgan_tpu_torch.tools.prepare_data lmdb --src DIR \\
        --dst DIR [--hr-size 216] [--lr-size 54]
    python -m sradsgan_tpu_torch.tools.prepare_data classdirs --src DIR \\
        --dst DIR [--size 216] [--scale 4]
"""

from __future__ import annotations

import argparse
import io
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

from sradsgan_tpu_torch.data.datasets import is_image_file


def _walk_images(src: str) -> List[str]:
    """Every image file under ``src``, directory by directory as
    ``os.walk`` visits them, sorted within each directory."""
    files = []
    for root, _, fnames in os.walk(src):
        files.extend(os.path.join(root, f) for f in sorted(fnames)
                     if is_image_file(f))
    return files


def _triplet(path: str, hr_size: int, lr_size: int):
    """(hr, lr, sr) PIL images of one file: the centered ``hr_size`` crop,
    its BICUBIC downsample and that re-upsampled BICUBIC."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    left, top = (w - hr_size) // 2, (h - hr_size) // 2
    hr = img.crop((left, top, left + hr_size, top + hr_size)) \
        if (w, h) != (hr_size, hr_size) else img
    lr = hr.resize((lr_size, lr_size), Image.BICUBIC)
    sr = lr.resize((hr_size, hr_size), Image.BICUBIC)
    return hr, lr, sr


def prepare_triplets(src: str, dst: str, hr_size: int, lr_size: int,
                     workers: int = 8) -> int:
    """Write ``lr_{l}`` / ``hr_{r}`` / ``sr_{l}_{r}`` folders of pngs named
    ``{i:05d}.png`` (GDP's layout) under ``dst``; returns the image count."""
    names = {
        "lr": os.path.join(dst, f"lr_{lr_size}"),
        "hr": os.path.join(dst, f"hr_{hr_size}"),
        "sr": os.path.join(dst, f"sr_{lr_size}_{hr_size}"),
    }
    for d in names.values():
        os.makedirs(d, exist_ok=True)
    files = _walk_images(src)

    def process(idx_path):
        idx, path = idx_path
        hr, lr, sr = _triplet(path, hr_size, lr_size)
        stem = f"{idx:05d}.png"
        hr.save(os.path.join(names["hr"], stem))
        lr.save(os.path.join(names["lr"], stem))
        sr.save(os.path.join(names["sr"], stem))

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(process, enumerate(files)))
    return len(files)


def iter_triplet_records(src: str, hr_size: int, lr_size: int
                         ) -> Iterator[Tuple[bytes, bytes]]:
    """The GDP LMDB records of an image folder as (key, png bytes):
    ``hr_{r}_{i:05d}``, ``lr_{l}_{i:05d}``, ``sr_{l}_{r}_{i:05d}`` for each
    image, then ``b"length"`` -> the count (GDP_x0/data/LRHR_dataset.py:
    62-76).  Apart from the writer, so that the schema is testable without
    the lmdb package."""

    def png(img) -> bytes:
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        return buf.getvalue()

    files = _walk_images(src)
    for idx, path in enumerate(files):
        hr, lr, sr = _triplet(path, hr_size, lr_size)
        tag = f"{idx:05d}"
        yield f"hr_{hr_size}_{tag}".encode(), png(hr)
        yield f"lr_{lr_size}_{tag}".encode(), png(lr)
        yield f"sr_{lr_size}_{hr_size}_{tag}".encode(), png(sr)
    yield b"length", str(len(files)).encode()


def prepare_lmdb(src: str, dst: str, hr_size: int, lr_size: int,
                 map_size: int = 1 << 32) -> int:
    """Write GDP's LMDB layout at ``dst`` (needs the lmdb package); returns
    the image count."""
    try:
        import lmdb
    except ImportError as e:
        raise ImportError("writing lmdb datasets needs the 'lmdb' package "
                          "(not bundled in this image); use the folder "
                          "layout (triplets) instead") from e
    env = lmdb.open(dst, map_size=map_size)
    n = 0
    with env.begin(write=True) as txn:
        for key, value in iter_triplet_records(src, hr_size, lr_size):
            txn.put(key, value)
            n += 1
    env.close()
    return (n - 1) // 3


def prepare_classdirs(src: str, dst: str, size: int, scale: int,
                      workers: int = 8) -> int:
    """For each class folder of ``src``, the BICUBIC ``size // scale``
    downsample of each image's centered ``size`` crop, as a png of the same
    stem in the same class folder under ``dst``; returns the image count."""
    from PIL import Image

    jobs = []
    for cls in sorted(os.listdir(src)):
        cdir = os.path.join(src, cls)
        if not os.path.isdir(cdir):
            continue
        odir = os.path.join(dst, cls)
        os.makedirs(odir, exist_ok=True)
        for f in sorted(os.listdir(cdir)):
            if is_image_file(f):
                jobs.append((os.path.join(cdir, f), os.path.join(odir, f)))

    def process(job):
        src_f, dst_f = job
        img = Image.open(src_f).convert("RGB")
        w, h = img.size
        left, top = (w - size) // 2, (h - size) // 2
        img = img.crop((left, top, left + size, top + size))
        img.resize((size // scale, size // scale), Image.BICUBIC).save(
            os.path.splitext(dst_f)[0] + ".png")

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(process, jobs))
    return len(jobs)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="prepare_data",
        description="Build GDP triplet folders, GDP LMDB records or "
                    "per-class LR folders from an image folder")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for cmd in ("triplets", "lmdb"):
        p = sub.add_parser(cmd)
        p.add_argument("--src", required=True)
        p.add_argument("--dst", required=True)
        p.add_argument("--hr-size", type=int, default=216)
        p.add_argument("--lr-size", type=int, default=54)
    p = sub.add_parser("classdirs")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--size", type=int, default=216)
    p.add_argument("--scale", type=int, default=4)
    args = parser.parse_args(argv)
    if args.cmd == "triplets":
        n = prepare_triplets(args.src, args.dst, args.hr_size, args.lr_size)
    elif args.cmd == "lmdb":
        n = prepare_lmdb(args.src, args.dst, args.hr_size, args.lr_size)
    else:
        n = prepare_classdirs(args.src, args.dst, args.size, args.scale)
    print(f"processed {n} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
