"""OCR checkpoints: EasyOCR's CRAFT and recognizer state dicts -> the port's
modules (port of eioku_tpu/models/ocr/weights.py).

The detector is `{cache_dir}/craft_mlt_25k.pth`; the recognizer
`{cache_dir}/{recognizer}.pth`, where the latin family falls back to
`english_g2.pth`. Both load by key names (models/ocr/craft.py, crnn.py).
Without a checkpoint a module takes random weights from a seeded
torch.Generator.
"""
from __future__ import annotations

import logging
import os

import torch

from eioku_tpu_torch.models.ocr.craft import CRAFT, load_craft_state_dict
from eioku_tpu_torch.models.ocr.crnn import CRNN, LATIN_CHARSET, load_easyocr_recognizer

log = logging.getLogger(__name__)

# language -> EasyOCR generation-2 recognizer model (all share the
# None-VGG-BiLSTM-CTC architecture; only n_classes/charset differ);
# languages outside this map use the latin model.
RECOGNIZER_FOR_LANGUAGE = {
    "ja": "japanese_g2",
    "ko": "korean_g2",
    "zh": "zh_sim_g2",
    "ru": "cyrillic_g2", "uk": "cyrillic_g2", "be": "cyrillic_g2",
    "bg": "cyrillic_g2", "mn": "cyrillic_g2", "sr": "cyrillic_g2",
    "ar": "arabic_g2", "fa": "arabic_g2", "ur": "arabic_g2",
    "hi": "devanagari_g2", "mr": "devanagari_g2", "ne": "devanagari_g2",
    "th": "thai_g2",
    "el": "greek_g2",
    "bn": "bengali_g2",
    "te": "telugu_g2",
    "kn": "kannada_g2",
}


def recognizer_for_language(lang: str) -> str:
    return RECOGNIZER_FOR_LANGUAGE.get(lang.lower(), "latin_g2")


def _load_charset(cache_dir: str, model: str) -> str | None:
    """Charset sidecar `{model}_chars.txt` (the character list the checkpoint
    was trained with, one line or one char per line; index 0 stays CTC blank).
    """
    path = os.path.join(cache_dir, f"{model}_chars.txt")
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as f:
        text = f.read()
    lines = [ln for ln in text.split("\n") if ln != ""]
    # one char per line (EasyOCR's char files) vs a single charset string
    if len(lines) > 1 and all(len(ln) == 1 for ln in lines):
        return "".join(lines)
    return text.rstrip("\n")


def _state_dict(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=False)


def load_ocr_checkpoints(cache_dir: str | None, recognizer: str = "latin_g2",
                         seed: int = 0) -> tuple[CRAFT, CRNN, str, bool]:
    """Returns (craft, crnn, charset, pretrained?), fp32 on the CPU.

    For the latin family `english_g2.pth` doubles as a fallback and the
    built-in latin charset covers it. Other scripts need a charset sidecar
    (above); without one the recognizer falls back to latin so output stays
    well-defined; so does a non-latin recognizer with no checkpoint."""
    craft = crnn = None
    charset = LATIN_CHARSET
    if cache_dir:
        cpath = os.path.join(cache_dir, "craft_mlt_25k.pth")
        if os.path.isfile(cpath):
            craft = load_craft_state_dict(_state_dict(cpath))
        names = [f"{recognizer}.pth"]
        if recognizer == "latin_g2":
            names.append("english_g2.pth")
        for name in names:
            rpath = os.path.join(cache_dir, name)
            if not os.path.isfile(rpath):
                continue
            model = name.removesuffix(".pth")
            cs = _load_charset(cache_dir, model)
            if cs is None and recognizer not in ("latin_g2", "english_g2"):
                log.warning("no charset sidecar %s_chars.txt for OCR model %s; "
                            "falling back to the latin recognizer", model, model)
                continue
            crnn = load_easyocr_recognizer(_state_dict(rpath))
            if cs is not None:
                charset = cs
            break
        if crnn is None and recognizer != "latin_g2":
            # non-latin model unavailable: retry with the latin family
            return load_ocr_checkpoints(cache_dir, "latin_g2", seed)
    pretrained = craft is not None and crnn is not None
    if craft is None:
        craft = CRAFT(generator=torch.Generator().manual_seed(seed)).eval()
    if crnn is None:
        crnn = CRNN(generator=torch.Generator().manual_seed(seed)).eval()
    return craft, crnn, charset, pretrained
