"""Hub-style convenience API (fairseq/hub_utils.py equivalent).

Counterpart of ``espresso_tpu/hub.py``: ``from_pretrained(ckpt_dir,
data_dir)`` loads a train-CLI checkpoint (the model rebuilt from the saved
``model_cfg.json``) and returns an interface whose ``transcribe()`` takes
wave paths, Kaldi rxfilenames or commands and returns text, decoding as
``cli/speech_recognize.py`` does (the feature front, then the task's
generator). It runs on the card unless the caller asks for the CPU.

    import espresso_tpu_torch.hub as hub
    asr = hub.from_pretrained("ckpts", data_dir="data", beam=10)
    print(asr.transcribe(["utt1.wav", "utt2.wav"]))
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Union

_WAVE_EXT = re.compile(r"\.(wav|wv1|wv2|flac|sph|ogg)$", re.IGNORECASE)


def _kind(audio: str) -> str:
    """The manifest key of an input: a command (ends with ``|``), a wave
    file by its extension, else a feature rxfilename."""
    if audio.rstrip().endswith("|"):
        return "command"
    if _WAVE_EXT.search(audio):
        return "wave"
    return "feat"


class EspressoHubInterface:
    def __init__(self, cfg, task, model, generator, prepare_features, device):
        self.cfg = cfg
        self.task = task
        self.model = model
        self.generator = generator
        self._prepare = prepare_features
        self.device = device

    @property
    def dictionary(self):
        return self.task.dictionary

    def transcribe(self, inputs: Sequence[str], nbest: int = 1) -> Union[List[str], List[List[str]]]:
        """inputs: wave paths / 'ark:offset' feature rxfilenames. Returns the
        1-best transcript per input (or n-best lists when nbest > 1)."""
        from espresso_tpu_torch.cli.train import put_batch

        tmpdir = tempfile.mkdtemp(prefix="espresso_hub_")
        manifest = OrderedDict()
        ids = []
        for i, audio in enumerate(inputs):
            utt = f"hub_utt{i:06d}"
            ids.append(utt)
            manifest[utt] = {_kind(audio): audio}
        with open(os.path.join(tmpdir, "hub.json"), "w") as f:
            json.dump(manifest, f)
        saved_data = self.cfg.dataset.data
        self.task.datasets.pop("hub", None)
        self.cfg.dataset.data = tmpdir
        results: Dict[str, List[str]] = {}
        try:
            try:
                ds = self.task.load_dataset("hub")
            finally:
                self.cfg.dataset.data = saved_data
            itr = self.task.get_batch_iterator(
                ds, self.cfg.dataset.max_tokens, self.cfg.dataset.batch_size or 8, shuffle=False
            ).next_epoch_itr()
            for group in itr:
                dev_group = put_batch(group, self.device)
                for i in range(group["prev_output_tokens"].shape[0]):
                    dec = self._prepare({k: v[i] for k, v in dev_group.items()})
                    hypos = self.generator.decode(dec)
                    for b, hyp_list in enumerate(hypos):
                        if group["weight"][i][b] <= 0:
                            continue
                        results[group["utt_ids"][i][b]] = [
                            self.dictionary.tokens_to_sentence(self.dictionary.string(h["tokens"]))
                            for h in hyp_list[:nbest]
                        ]
        finally:
            # an exception mid-decode must not leak the tmpdir or leave the
            # 'hub' dataset cached on the task
            shutil.rmtree(tmpdir, ignore_errors=True)
            self.task.datasets.pop("hub", None)
        if nbest == 1:
            return [results.get(u, [""])[0] for u in ids]
        return [results.get(u, []) for u in ids]


def from_pretrained(
    ckpt_dir: str,
    data_dir: Optional[str] = None,
    dict_path: Optional[str] = None,
    beam: int = 1,
    device="cuda",
    **overrides,
) -> EspressoHubInterface:
    """Build a decode-ready interface from a train-CLI checkpoint directory,
    on ``device``. ``overrides`` are dotted config keys (e.g.
    ``**{"generation.lm_weight": 0.4}``)."""
    from espresso_tpu_torch.cli.speech_recognize import build_lm, load_model_for_decoding
    from espresso_tpu_torch.config import apply_saved_model_cfg, parse_config
    from espresso_tpu_torch.tasks import setup_task
    from espresso_tpu_torch.train.trainer import make_device_feature_fn

    argv = [f"{k}={v}" for k, v in overrides.items()]
    cfg = parse_config(argv)
    cfg.checkpoint.save_dir = ckpt_dir
    cfg.generation.beam = beam
    if data_dir:
        cfg.dataset.data = data_dir
    if dict_path:
        cfg.dataset.dict = dict_path
    elif not cfg.dataset.dict:
        for cand in (os.path.join(ckpt_dir, "dict.txt"), os.path.join(cfg.dataset.data or ".", "dict.txt")):
            if os.path.exists(cand):
                cfg.dataset.dict = cand
                break
    apply_saved_model_cfg(cfg, argv)
    task = setup_task(cfg)
    model = load_model_for_decoding(cfg, task, device)
    lm = build_lm(cfg, task, device)
    generator = task.build_generator(model, cfg.generation, lm=lm, lm_weight=cfg.generation.lm_weight)
    return EspressoHubInterface(cfg, task, model, generator, make_device_feature_fn(cfg), device)
