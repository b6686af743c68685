"""JSON manifest reader — Espresso-compatible schema.

The port's own copy of ``espresso_tpu/data/manifest.py`` (no JAX in it,
but the JAX package's ``data/__init__`` loads jax).

The manifest format is the reference's data json
(espresso/tasks/speech_recognition.py:144-159, produced by
espresso/tools/asr_prep_json.py):

    {
      "011c0202": {
        "feat": "fbank/raw_fbank_train.1.ark:54819"   # OR
        "wave": "/path/011c0202.wv1"                  # OR
        "command": "sph2pipe -f wav /path/x.wv1 |",
        "text": "THE HOTEL",
        "utt2num_frames": "693"
      }, ...
    }

Sharded splits ``{split}.json, {split}1.json, {split}2.json ...`` are combined
(reference :163-232).
"""

from __future__ import annotations

import itertools
import json
import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class ManifestEntry:
    utt_id: str
    audio: str  # feat rxfilename | wave path | shell command
    kind: str  # "feat" | "wave" | "command"
    text: Optional[str]
    num_frames: Optional[int]
    # hybrid extras: alignment / numerator_fst / token_text rxfilenames
    alignment: Optional[str] = None
    numerator_fst: Optional[str] = None
    token_text: Optional[str] = None


def load_manifest(
    data_path: str, split: str, combine: bool = True
) -> List[ManifestEntry]:
    entries: List[ManifestEntry] = []
    for k in itertools.count():
        split_k = split + (str(k) if k > 0 else "")
        path = os.path.join(data_path, f"{split_k}.json")
        if not os.path.isfile(path):
            if k > 0:
                break
            raise FileNotFoundError(f"Dataset not found: {path}")
        with open(path, "rb") as f:
            loaded = json.load(f, object_pairs_hook=OrderedDict)
        for utt_id, val in loaded.items():
            for kind in ("feat", "wave", "command"):
                if kind in val:
                    audio = val[kind]
                    break
            else:
                raise KeyError(
                    f"'feat', 'wave' or 'command' required for entry {utt_id} in {path}"
                )
            entries.append(
                ManifestEntry(
                    utt_id=utt_id,
                    audio=audio,
                    kind=kind,
                    text=val.get("text"),
                    num_frames=(
                        int(val["utt2num_frames"])
                        if "utt2num_frames" in val
                        else None
                    ),
                    alignment=val.get("alignment"),
                    numerator_fst=val.get("numerator_fst"),
                    token_text=val.get("token_text"),
                )
            )
        if not combine:
            break
    return entries


def save_manifest(entries: List[ManifestEntry], path: str) -> None:
    obj = OrderedDict()
    for e in entries:
        rec = OrderedDict()
        rec[e.kind] = e.audio
        if e.text is not None:
            rec["text"] = e.text
        if e.num_frames is not None:
            rec["utt2num_frames"] = str(e.num_frames)
        obj[e.utt_id] = rec
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2)
