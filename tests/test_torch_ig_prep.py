"""The port's IGNav packer (`wiw_tpu_torch/data/ig_dataset_prep.py`) against
the reference's: both write the same bundle, and the port's `IGDataset`
reads what the port's packer writes."""

import copy
import gzip
import json
import zipfile

import numpy as np
import pytest
from PIL import Image

from wiw_tpu.data import ig_dataset_prep as J
from wiw_tpu_torch.agents.datasets import IGDataset
from wiw_tpu_torch.data import ig_dataset_prep as T


@pytest.fixture
def episodes(tmp_path):
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    eps = []
    for i in range(3):
        p = imgs / f"goal{i}.png"
        Image.fromarray(np.full((8, 8, 3), i * 40, np.uint8)).save(p)
        eps.append({"episode_id": i, "scene_id": "s", "goal_image_path": f"goal{i}.png"})
    return eps, str(imgs)


def _bundle(json_path, zip_path):
    with gzip.open(json_path, "rt") as f:
        data = json.load(f)
    with zipfile.ZipFile(zip_path) as zf:
        files = {n: zf.read(n) for n in zf.namelist()}
    return data, files


@pytest.mark.parametrize("how", ["function", "cli"])
def test_port_packer_writes_the_references_bundle(episodes, tmp_path, how):
    eps, root = episodes
    out = {}
    for name, mod in (("ref", J), ("port", T)):
        js, zp = str(tmp_path / f"{name}.json.gz"), str(tmp_path / f"{name}.zip")
        if how == "function":
            mod.pack_ig_dataset(copy.deepcopy(eps), js, zp, image_root=root)
        else:
            src = tmp_path / f"{name}_in.json"
            src.write_text(json.dumps({"episodes": eps}))
            mod.main(["--episodes", str(src), "--image_root", root, "--out_json", js,
                      "--out_zip", zp])
        out[name] = _bundle(js, zp)
    assert out["port"] == out["ref"]
    assert sorted(out["port"][1]) == [f"goals/goal{i}.png" for i in range(3)]


def test_port_dataset_reads_the_port_packers_bundle(episodes, tmp_path):
    eps, root = episodes
    js, zp = str(tmp_path / "episodes_IG.json.gz"), str(tmp_path / "goals.zip")
    T.pack_ig_dataset(copy.deepcopy(eps), js, zp, image_root=root)
    ds = IGDataset(js, goal_zip=zp, cache_dir=str(tmp_path / "cache"))
    assert len(ds) == 3
    for i in range(3):
        arr = np.asarray(Image.open(ds.goal_image_path(ds[i])))
        assert arr.shape == (8, 8, 3) and (arr == i * 40).all()
