"""u2seg_torch's model zoo: the port twin of the JAX package's
``tests/config/test_config_zoo.py`` (every YAML of ``configs/`` loads and
builds, here on ``device="cpu"`` with the port's seeded init), and of its
model-zoo API test. All 31 files build: 28 over ResNet-FPN, and the RegNet,
Swin and ViTDet files over their trunks (``TRUNKS``), whose modules the
build checks.
"""
import os

import pytest
import torch

from u2seg_torch import model_zoo
from u2seg_torch.config import load_config
from u2seg_torch.models.build import build_model

torch.set_num_threads(1)

ZOO = model_zoo.list_configs()
TRUNKS = {"Misc/mask_rcnn_regnetx_4gf_fpn_3x.yaml": ("TrunkFPN", "RegNet"),
          "Misc/mask_rcnn_swin_t_fpn_3x.yaml": ("TrunkFPN", "SwinTransformer"),
          "ViTDet/mask_rcnn_vitdet_b_100ep.yaml": ("ViTDet", "ViT")}
MODULES = {"PanopticFPN": "PanopticFPN", "GeneralizedRCNN": "GeneralizedRCNN",
           "ProposalNetwork": "ProposalNetwork", "SemanticSegmentor": "SemanticSegmentor",
           "RetinaNet": "DenseDetectorMetaArch", "FCOS": "DenseDetectorMetaArch"}


def test_the_zoo_has_31_configs():
    assert len(ZOO) == 31 and set(TRUNKS) <= set(ZOO)
    assert not any(os.path.basename(p).startswith("Base-") for p in ZOO)


@pytest.mark.parametrize("rel", ZOO, ids=[p.replace("/", ":") for p in ZOO])
def test_config_loads_and_builds(rel):
    cfg = load_config(model_zoo.get_config_file(rel))
    assert cfg.model.roi_heads.mask_on == cfg.model.mask_on
    assert cfg.model.roi_heads.keypoint_on == cfg.model.keypoint_on
    model = build_model(cfg, device="cpu")
    assert type(model).__name__ == MODULES[cfg.model.meta_architecture]
    backbone, trunk = TRUNKS.get(rel, ("FPN", "ResNet"))
    assert type(model.backbone).__name__ == backbone
    bottom_up = model.backbone.net if backbone == "ViTDet" else model.backbone.bottom_up
    assert type(bottom_up).__name__ == trunk
    assert not model.training
    assert next(model.parameters()).device.type == "cpu"
    heads = getattr(model, "roi_heads", None)
    if heads is not None:
        assert hasattr(heads, "mask_head") == cfg.model.mask_on
        assert hasattr(heads, "keypoint_head") == cfg.model.keypoint_on


def test_an_unknown_backbone_is_refused():
    cfg = model_zoo.get_config("COCO-Detection/faster_rcnn_R_50_FPN_1x.yaml")
    cfg.model.backbone.name = "NoSuchFPN"
    with pytest.raises(KeyError, match="Unknown backbone: NoSuchFPN"):
        build_model(cfg, device="cpu")


def test_model_zoo_api():
    path = model_zoo.get_config_file("COCO-Detection/faster_rcnn_R_50_FPN_1x.yaml")
    assert os.path.isfile(path)
    cfg = model_zoo.get_config("COCO-Detection/faster_rcnn_R_50_FPN_1x.yaml")
    assert cfg.model.meta_architecture == "GeneralizedRCNN"
    assert cfg.model.weights == ""
    model, cfg2 = model_zoo.get("COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml",
                                device="cpu")
    assert model is not None and cfg2.model.mask_on
    assert hasattr(model.roi_heads, "mask_head")
    assert "COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml" in ZOO
    with pytest.raises(RuntimeError):
        model_zoo.get_config_file("nope/nothing.yaml")


def test_get_trained_loads_the_configs_weights(tmp_path, monkeypatch):
    rel = "COCO-Detection/retinanet_R_50_FPN_1x.yaml"
    src = build_model(model_zoo.get_config(rel), device="cpu", seed=3)
    path = str(tmp_path / "retinanet.pth")
    torch.save({"model": src.state_dict()}, path)
    get_config = model_zoo.get_config

    def with_weights(config_path, trained=False):
        cfg = get_config(config_path, trained)
        if trained:
            cfg.model.weights = path
        return cfg

    monkeypatch.setattr(model_zoo, "get_config", with_weights)
    fresh, _ = model_zoo.get(rel, device="cpu")
    trained, cfg = model_zoo.get(rel, trained=True, device="cpu")
    assert cfg.model.weights == path
    w = "head.cls_score.weight"
    assert torch.equal(trained.state_dict()[w], src.state_dict()[w])
    assert not torch.equal(fresh.state_dict()[w], src.state_dict()[w])


# ---------------------------------------------------------------------------
# The engine serves and trains PanopticFPN only, as in the JAX package; the
# port says so where the JAX package fails later or trains the wrong model
# ---------------------------------------------------------------------------

MASK_RCNN = "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml"


def test_the_trainer_refuses_a_detector_config(tmp_path):
    from u2seg_torch.engine.train_loop import DefaultTrainer
    from u2seg_torch.engine.trainer import create_train_state
    from u2seg_torch.tools import train_net

    cfg = model_zoo.get_config(MASK_RCNN)
    msg = "'GeneralizedRCNN' does not train through the trainer: only PanopticFPN"
    with pytest.raises(ValueError, match=msg):
        create_train_state(cfg, device="cpu")
    with pytest.raises(ValueError, match=msg):
        DefaultTrainer(cfg, [], device="cpu")
    # before it reads any data (the YAML's COCO sets are not on disk)
    with pytest.raises(ValueError, match=msg):
        train_net.main(["--config-file", model_zoo.get_config_file(MASK_RCNN),
                        "--device", "cpu", f"output_dir={tmp_path}"])


def test_the_predictor_refuses_a_detector_config():
    from u2seg_torch.engine.predictor import DefaultPredictor

    for rel in (MASK_RCNN, "COCO-Detection/retinanet_R_50_FPN_1x.yaml"):
        cfg = model_zoo.get_config(rel)
        with pytest.raises(ValueError, match="does not run through the predictor"):
            DefaultPredictor(cfg, device="cpu")
