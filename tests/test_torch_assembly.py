"""u2seg_torch's pseudo-annotation assembly against the JAX package's
(``u2seg_tpu/pseudo/assembly.py``), bit for bit: every function on the same
inputs gives equal outputs (arrays equal, JSON-able dicts equal), and the
panoptic PNGs the port writes read back through the JAX package's reader
as the same map."""
import json

import numpy as np
import pytest

from u2seg_tpu.evaluation import rle as jrle
from u2seg_tpu.pseudo import assembly as ja
from u2seg_torch.pseudo import assembly as ta
from u2seg_torch.testing import write_synthetic_pseudo_inputs


def ann(mask, cat, aid, img=1, area=None):
    r = jrle.encode(mask.astype(np.uint8))
    r["counts"] = r["counts"].decode("ascii")
    return {"id": aid, "image_id": img, "category_id": cat, "segmentation": r,
            "area": int(mask.sum()) if area is None else area, "iscrowd": 0}


def scene_anns(seed, h=40, w=56, n=9):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        cy, cx, r = rng.rand() * h, rng.rand() * w, 3 + rng.rand() * 12
        out.append(ann(((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r, int(rng.randint(1, 9)), i + 1))
    # one hidden under a later (smaller) paste, one with an area tie
    big = np.zeros((h, w), bool)
    big[5:15, 5:15] = True
    small = np.zeros((h, w), bool)
    small[6:9, 6:9] = True
    out += [ann(small, 3, 90), ann(small, 4, 91, area=9), ann(big, 5, 92)]
    stego = np.repeat(rng.randint(0, 27, (4, 7)), [10] * 4, 0).repeat(8, 1)
    return out, stego.astype(np.int64), (h, w)


def test_id2rgb_rgb2id_match_jax():
    ids = np.random.RandomState(0).randint(0, 256 ** 3, (9, 7)).astype(np.int64)
    np.testing.assert_array_equal(ta.id2rgb(ids), ja.id2rgb(ids))
    np.testing.assert_array_equal(ta.rgb2id(ja.id2rgb(ids)), ids)


def test_assign_cluster_ids_matches_jax():
    anns, _, _ = scene_anns(0)
    src = {"images": [{"id": 1}], "annotations": anns, "categories": [{"id": 1, "name": "fg"}]}
    decode = {f"1_{a['id']}": int(i * 7 % 11) for i, a in enumerate(anns) if i % 4}
    before = [a["category_id"] for a in anns]
    want = ja.assign_cluster_ids(src, decode, 11)
    got = ta.assign_cluster_ids(src, decode, 11)
    assert got == want and len(got["annotations"]) == len(decode)
    assert [a["category_id"] for a in src["annotations"]] == before     # input untouched


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_and_semantic_match_jax(seed):
    anns, stego, hw = scene_anns(seed)
    for a in anns:
        a["category_id"] = 1 + a["id"] % 13
    jpan, jsegs = ja.merge_instances_and_stego(anns, stego, 13, hw)
    tpan, tsegs = ta.merge_instances_and_stego(anns, stego, 13, hw)
    np.testing.assert_array_equal(tpan, jpan)
    assert tsegs == jsegs
    assert any(s["isthing"] == 0 for s in tsegs)
    for base in (13, None):
        np.testing.assert_array_equal(ta.panoptic_to_semantic(tpan, tsegs, stuff_base=base),
                                      ja.panoptic_to_semantic(jpan, jsegs, stuff_base=base))


def test_overlap_skip_matches_jax():
    h = w = 20
    inst = np.zeros((h, w), bool)
    inst[:, :15] = True
    stego = np.zeros((h, w), np.int64)
    stego[:, 10:] = 4
    anns = [ann(inst, 2, 1)]
    for skip in (0.7, 0.2, 0.0):
        jp, js = ja.merge_instances_and_stego(anns, stego, 5, (h, w), overlap_skip=skip)
        tp, ts = ta.merge_instances_and_stego(anns, stego, 5, (h, w), overlap_skip=skip)
        np.testing.assert_array_equal(tp, jp)
        assert ts == js


def test_supercategories_match_jax(tmp_path):
    ds = write_synthetic_pseudo_inputs(str(tmp_path), [(30, 40), (40, 30)], instances_per_image=2)
    with open(ds.gt_panoptic_json) as f:
        gt = json.load(f)
    for n in (7, 800):
        got = ta.gt_panoptic_to_supercategories(gt, n)
        assert got == ja.gt_panoptic_to_supercategories(gt, n)
        sup = {c["id"] for c in got["categories"] if not c["isthing"]}
        assert sup == set(range(n + 1, n + 16))


def test_port_pngs_read_back_through_jax(tmp_path):
    anns, stego, hw = scene_anns(5)
    pan, _ = ta.merge_instances_and_stego(anns, stego, 800, hw)
    pan[0, :3] = [256 * 256 * 3 + 7, 70000, 255]          # ids past one byte
    path = str(tmp_path / "p.png")
    ta.write_panoptic_png(pan, path)
    np.testing.assert_array_equal(ja.read_panoptic_png(path), pan)
    ja.write_panoptic_png(pan, str(tmp_path / "q.png"))
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "q.png").read_bytes()
    np.testing.assert_array_equal(ta.read_panoptic_png(str(tmp_path / "q.png")), pan)


def test_a_polygon_segmentation_raises_in_both():
    """Both packages decode every segmentation of the merge as RLE (CutLER
    writes RLE); a polygon raises the same error in each."""
    a = {"id": 1, "image_id": 1, "category_id": 2, "area": 10,
         "segmentation": [[1, 1, 8, 1, 8, 8, 1, 8]]}
    for mod in (ja, ta):
        with pytest.raises(TypeError, match="list indices"):
            mod.merge_instances_and_stego([a], np.zeros((10, 10), np.int64), 5, (10, 10))
