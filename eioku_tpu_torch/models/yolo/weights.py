"""YOLOv8 weights for the port: ultralytics state dicts and JAX parameter trees.

`load_ultralytics_state_dict` reads the torch layout natively: the module's
blocks carry ultralytics' own sub-keys (`conv`, `bn`, `cv1`, `m.j`, ...), so
only the top-level layer index maps to a block name (public yolov8 yaml):

  0 stem, 1 down1, 2 c2f_1, 3 down2, 4 c2f_2, 5 down3, 6 c2f_3, 7 down4,
  8 c2f_4, 9 sppf, 12 neck_c2f_td1, 15 neck_c2f_td2, 16 neck_down1,
  18 neck_c2f_bu1, 19 neck_down2, 21 neck_c2f_bu2, 22 detect
  (22.cv2.<lvl> -> head_box[lvl], 22.cv3.<lvl> -> head_cls[lvl])

`from_jax_params` carries the JAX package's parameter tree (nested dicts of
arrays, HWIO convs, unfolded batch norm) over into the module (OIHW).
"""
from __future__ import annotations

import re

import numpy as np
import torch

from eioku_tpu_torch.models.yolo.model import YOLOv8, YoloConfig

_BLOCK_TO_INDEX = {
    "stem": 0, "down1": 1, "c2f_1": 2, "down2": 3, "c2f_2": 4, "down3": 5,
    "c2f_3": 6, "down4": 7, "c2f_4": 8, "sppf": 9, "neck_c2f_td1": 12,
    "neck_c2f_td2": 15, "neck_down1": 16, "neck_c2f_bu1": 18,
    "neck_down2": 19, "neck_c2f_bu2": 21,
}
_INDEX_TO_BLOCK = {str(i): b for b, i in _BLOCK_TO_INDEX.items()}
_DETECT_INDEX = "22"
_HEADS = {"cv2": "head_box", "cv3": "head_cls"}


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _load_into(model: YOLOv8, sd: dict[str, torch.Tensor]) -> YOLOv8:
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"yolo weights do not fit {model.cfg.variant}: "
                       f"missing {missing[:5]}, unexpected {unexpected[:5]}")
    return model


def load_ultralytics_state_dict(sd: dict, cfg: YoloConfig) -> YOLOv8:
    """An ultralytics DetectionModel state dict (keys 'model.N.' or 'N.')
    -> the port's YOLOv8 module, batch norm unfolded."""
    mapped: dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        while key.startswith("model."):
            key = key[len("model."):]
        idx, _, rest = key.partition(".")
        if rest.endswith("num_batches_tracked"):
            continue
        if idx == _DETECT_INDEX:
            branch, _, tail = rest.partition(".")
            if branch not in _HEADS:  # the DFL's fixed arange conv
                continue
            mapped[f"{_HEADS[branch]}.{tail}"] = _as_tensor(value)
        elif idx in _INDEX_TO_BLOCK:
            mapped[f"{_INDEX_TO_BLOCK[idx]}.{rest}"] = _as_tensor(value)
        else:
            raise KeyError(f"unexpected ultralytics key {key!r}")
    return _load_into(YOLOv8(cfg), mapped)


def load_yolo_checkpoint(path: str, cfg: YoloConfig) -> YOLOv8:
    """Load an ultralytics .pt checkpoint (CPU) into the port's module."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        sd = obj.state_dict()
    elif isinstance(obj, dict) and "model" in obj:
        model = obj["model"]
        sd = model.state_dict() if hasattr(model, "state_dict") else model
    else:
        sd = obj
    return load_ultralytics_state_dict(sd, cfg)


def _jax_tree_to_state_dict(p, prefix: str, out: dict) -> None:
    if isinstance(p, list):
        for j, v in enumerate(p):
            _jax_tree_to_state_dict(v, f"{prefix}.{j}", out)
        return
    if "w" not in p:
        for k, v in p.items():
            # head_box_0 -> head_box.0 (a ModuleList here)
            name = re.sub(r"^(head_box|head_cls)_(\d+)$", r"\1.\2", k)
            _jax_tree_to_state_dict(v, f"{prefix}.{name}" if prefix else name, out)
        return
    w = torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))))  # HWIO -> OIHW
    if "bn" in p:
        bn = p["bn"]
        out[f"{prefix}.conv.weight"] = w
        out[f"{prefix}.bn.weight"] = _as_tensor(bn["gamma"])
        out[f"{prefix}.bn.bias"] = _as_tensor(bn["beta"])
        out[f"{prefix}.bn.running_mean"] = _as_tensor(bn["mean"])
        out[f"{prefix}.bn.running_var"] = _as_tensor(bn["var"])
    else:  # the head's final plain conv
        out[f"{prefix}.weight"] = w
        out[f"{prefix}.bias"] = _as_tensor(p["b"])


def from_jax_params(tree: dict, cfg: YoloConfig) -> YOLOv8:
    """The JAX package's YOLO parameter tree (as `init_yolo_params` returns
    it: nested dicts of arrays, HWIO convs, unfolded batch norm) -> the
    port's module, batch norm unfolded."""
    sd: dict[str, torch.Tensor] = {}
    _jax_tree_to_state_dict(tree, "", sd)
    return _load_into(YOLOv8(cfg), sd)
