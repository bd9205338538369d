"""Eval-shape census, PyTorch port (mrfp_tpu/cli/shape_census.py): how
many distinct image shapes an exact-shape parity sweep meets per domain.

    python -m mrfp_tpu_torch.cli.shape_census --data-root /data --domains mapillary

Reads only PNG/JPEG headers (no pixel decode), applies each domain's val
transform's shape arithmetic, and prints the census of post-transform
shapes:

- Mapillary's val transform is ResizeHeight(1536) + CenterCropPad(1536)
  (main.py:775-783), and CenterCropPad's final crop is always exactly
  (1536, 1536) (dataloaders.py:354-394), so a Mapillary sweep runs one
  shape, whatever the native widths.
- Cityscapes, BDD and SYNTHIA evaluate at their one native shape
  (1024x2048, 720x1280, 760x1280).
- GTAV is the one mixed-shape domain (mostly 1914x1052, with a tail of odd
  sizes); the census counts them.

What a shape costs the port: nothing is compiled. A new shape costs cuDNN's
first-call algorithm choice for each of the forward's convolutions, and
one set of bilinear tap tables for each resize size it brings (built once
on the host, cached on the device, ``ops/resize.py``): seconds, paid once
per process, against minutes a shape for the JAX package's compile. A
``torch.export`` artifact (``cli.export``) is fixed to one shape: a fleet
that serves several shapes exports one artifact each.
"""

from __future__ import annotations

import argparse
import collections
import json
from typing import Dict, Iterable, Optional, Sequence, Tuple

ALL_DOMAINS = ["cityscapes", "bdd100k", "synthia", "mapillary", "gtav"]


def _image_sizes(paths: Iterable[str]):
    """(w, h) per file from headers only, no pixel decode."""
    from PIL import Image

    for p in paths:
        with Image.open(p) as im:
            yield im.size


def mapillary_val_shape(_w: int, _h: int, eval_size: int = 1536) -> Tuple[int, int]:
    """ResizeHeight + CenterCropPad: always (eval_size, eval_size)."""
    return (eval_size, eval_size)


def identity_val_shape(w: int, h: int) -> Tuple[int, int]:
    """ToTensor-only domains evaluate at the native shape (H, W)."""
    return (h, w)


def census(domain: str, root: str, eval_size: int = 1536, max_images: int = 0,
           split: Optional[str] = None) -> Dict[Tuple[int, int], int]:
    """{post-transform (H, W): count} for the domain's val split."""
    from mrfp_tpu_torch.data.datasets import DATASETS, VAL_SPLITS, domain_root

    ds = DATASETS[domain](root=domain_root(root, domain), split=split or VAL_SPLITS[domain],
                          train=False, eval_size=eval_size)
    files = ds.files[:max_images] if max_images else ds.files
    out: Dict[Tuple[int, int], int] = collections.Counter()
    for w, h in _image_sizes(files):
        out[mapillary_val_shape(w, h, eval_size) if domain == "mapillary"
            else identity_val_shape(w, h)] += 1
    return dict(out)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description="eval-shape census")
    p.add_argument("--data-root", default="/data")
    p.add_argument("--domains", nargs="+", default=ALL_DOMAINS,
                   help="domain names, or 'all' for the 5-domain sweep")
    p.add_argument("--eval-size", type=int, default=1536)
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--json-out", default=None)
    args = p.parse_args(argv)

    domains = ALL_DOMAINS if args.domains == ["all"] else args.domains
    report = {}
    for domain in domains:
        try:
            c = census(domain, args.data_root, args.eval_size, args.max_images)
        except FileNotFoundError as e:
            print(f"{domain}: SKIP ({e})")
            continue
        shapes = sorted(c.items(), key=lambda kv: -kv[1])
        print(f"{domain}: {sum(c.values())} images, {len(c)} distinct shapes")
        for (h, w), n in shapes[:10]:
            print(f"  {h}x{w}: {n}")
        if len(shapes) > 10:
            print(f"  ... {len(shapes) - 10} more")
        report[domain] = {"images": sum(c.values()), "distinct_shapes": len(c),
                          "census": {f"{h}x{w}": n for (h, w), n in shapes}}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    print("\nEach distinct shape costs the port cuDNN's first-call algorithm choice and "
          "one set of bilinear tap tables per resize size, once per process; nothing is "
          "compiled. cli.eval --bucket pads shapes up to multiples of N, and the "
          "SlidingEvaluator runs every image at one tile shape.")
    return report


if __name__ == "__main__":
    main()
