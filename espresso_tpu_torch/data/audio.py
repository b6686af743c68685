"""Waveform loading without external audio deps.

The port's own copy of ``espresso_tpu/data/audio.py``.

Replaces the reference's soundfile/torchaudio waveform path
(fairseq/data/audio/audio_utils.py, espresso/data/feat_text_dataset.py:132-149)
with a stdlib WAV reader plus shell-command pipes (Kaldi-style
``command ... |`` entries, e.g. sph2pipe). Values are returned in Kaldi
convention (int16-scaled floats), which the fbank front-end expects.
"""

from __future__ import annotations

import io
import struct
import subprocess
from typing import Tuple, Union

import numpy as np


def read_wav(source: Union[str, bytes, io.BytesIO]) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 samples in int16 scale, sample_rate)."""
    import wave

    if isinstance(source, bytes):
        source = io.BytesIO(source)
    with wave.open(source, "rb") as w:
        sample_rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 65536.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, sample_rate


def read_audio(rxfile: str, kind: str) -> Tuple[np.ndarray, int]:
    """Load audio per manifest kind: 'wave' path or 'command' shell pipe."""
    if kind == "command":
        out = subprocess.run(
            rxfile.rstrip().rstrip("|"), shell=True, stdout=subprocess.PIPE, check=True
        ).stdout
        return read_wav(out)
    return read_wav(rxfile)
