"""IGNav dataset packing: episodes + goal images -> portable zip bundle.

The port's copy of `wiw_tpu/data/ig_dataset_prep.py` (which imports
neither jax nor the reference package; the port keeps its own copy of such
modules). Behavioural parity with process_IGnav_dataset/pickle_dataset.py:
105-165: collects per-episode goal images into one zip (lazily unzipped at
load time by wiw_tpu_torch/agents/datasets.IGDataset) and writes the
episode list as episodes_IG.json.gz with `goal_image` entries pointing
into the zip.

    python -m wiw_tpu_torch.data.ig_dataset_prep --episodes EPS.json.gz \
        --image_root DIR --out_json episodes_IG.json.gz --out_zip ig_goals.zip
"""

from __future__ import annotations

import argparse
import gzip
import json
import os.path as osp
import zipfile
from typing import List


def pack_ig_dataset(episodes: List[dict], out_json: str, out_zip: str,
                    image_root: str = "") -> None:
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_STORED) as zf:
        for ep in episodes:
            src = ep.get("goal_image_path") or ep.get("goal_image")
            assert src, f"episode {ep} lacks a goal image"
            full = osp.join(image_root, src) if image_root else src
            arc = osp.join("goals", osp.basename(src))
            zf.write(full, arc)
            ep["goal_image"] = arc
    with gzip.open(out_json, "wt") as f:
        json.dump({"episodes": episodes}, f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", required=True,
                    help="input episodes json(.gz) with goal_image_path")
    ap.add_argument("--image_root", default="")
    ap.add_argument("--out_json", default="episodes_IG.json.gz")
    ap.add_argument("--out_zip", default="ig_goals.zip")
    args = ap.parse_args(argv)
    op = gzip.open if args.episodes.endswith(".gz") else open
    with op(args.episodes, "rt") as f:
        data = json.load(f)
    eps = data["episodes"] if isinstance(data, dict) else data
    pack_ig_dataset(eps, args.out_json, args.out_zip, args.image_root)
    print(f"packed {len(eps)} episodes -> {args.out_json} + {args.out_zip}")


if __name__ == "__main__":
    main()
