"""Data-preparation CLIs (espresso/tools/* equivalents).

The port's own copy of ``espresso_tpu/cli/prep.py``, with the same
subcommands, arguments and IO formats (host code, numpy only):
  * ``asr_prep_json``    — wrap scp/text files into the JSON manifest
  * ``compute_cmvn``     — gcmvn.npz with mean/std over a feats.scp or manifest
  * ``text2token``       — words -> char tokens with <space>
  * ``text2vocabulary``  — a vocab with cutoffs + OOV stats
  * ``wav2num_frames``   — Kaldi frame counts for waves
  * ``compute_wer``      — offline WER between ref/hyp files
  * ``binarize``         — LM text into an mmap int32 token stream
    ({prefix}.bin/.idx, ``data/indexed_dataset.py``), byte for byte JAX's
  * ``estimate_state_prior`` (hybrid) is not ported and raises (ROADMAP
    queue A item 2)

Usage: ``python -m espresso_tpu_torch.cli.prep <subcommand> [args]``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from collections import Counter, OrderedDict

import numpy as np

from espresso_tpu_torch.cli.logging_utils import setup_logging

logger = logging.getLogger("espresso_tpu_torch.prep")


def _read_file(ordered_dict, key, dtype, *paths):
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for line in f:
                utt_id, val = line.strip().split(None, 1)
                if utt_id in ordered_dict:
                    assert key not in ordered_dict[utt_id], (
                        f"Duplicate utterance id {utt_id} in {key}"
                    )
                    ordered_dict[utt_id][key] = dtype(val)
                else:
                    ordered_dict[utt_id] = {key: dtype(val)}
    return ordered_dict


def asr_prep_json(argv):
    p = argparse.ArgumentParser(prog="asr_prep_json")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--feat-files", nargs="+")
    g.add_argument("--wave-files", nargs="+")
    g.add_argument("--command-files", nargs="+")
    p.add_argument("--token-text-files", nargs="+")
    p.add_argument("--text-files", nargs="+")
    p.add_argument("--numerator-fst-files", nargs="+")
    p.add_argument("--alignment-files", nargs="+")
    p.add_argument("--utt2num-frames-files", nargs="+")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    obj: OrderedDict = OrderedDict()
    if args.feat_files:
        _read_file(obj, "feat", str, *args.feat_files)
    elif args.wave_files:
        _read_file(obj, "wave", str, *args.wave_files)
    else:
        _read_file(obj, "command", str, *args.command_files)
    for key, files in (
        ("token_text", args.token_text_files),
        ("text", args.text_files),
        ("numerator_fst", args.numerator_fst_files),
        ("alignment", args.alignment_files),
    ):
        if files:
            _read_file(obj, key, str, *files)
    if args.utt2num_frames_files:
        _read_file(obj, "utt2num_frames", int, *args.utt2num_frames_files)
    with open(args.output, "w") as f:
        json.dump(obj, f, indent=4)
    logger.info("Dumped %d examples in %s", len(obj), args.output)


def compute_cmvn(argv):
    p = argparse.ArgumentParser(prog="compute_cmvn")
    p.add_argument("--feats-scp", help="Kaldi feats.scp")
    p.add_argument("--manifest", help="or: JSON manifest with feat entries")
    p.add_argument("--output", required=True, help="output .npz path")
    args = p.parse_args(argv)
    from espresso_tpu_torch.data import kaldi_io
    from espresso_tpu_torch.features.cmvn import compute_global_cmvn_stats

    def mats():
        if args.feats_scp:
            for _, rx in kaldi_io.read_scp(args.feats_scp):
                yield kaldi_io.read_mat(rx)
        else:
            with open(args.manifest) as f:
                for val in json.load(f).values():
                    yield kaldi_io.read_mat(val["feat"])

    stats = compute_global_cmvn_stats(mats())
    np.savez(args.output, mean=stats["mean"], std=stats["std"])
    logger.info("wrote CMVN stats (dim %d) to %s", len(stats["mean"]), args.output)


def text2token(argv):
    p = argparse.ArgumentParser(prog="text2token")
    p.add_argument("--skip-ncols", type=int, default=0)
    p.add_argument("--space", default="<space>")
    p.add_argument("--ends-with-space", action="store_true", default=True)
    p.add_argument("text_file", nargs="?", default="-")
    args = p.parse_args(argv)
    from espresso_tpu_torch.data.encoders import CharactersAsr

    tok = CharactersAsr(space_symbol=args.space, ends_with_space=args.ends_with_space)
    f = sys.stdin if args.text_file == "-" else open(args.text_file, encoding="utf-8")
    for line in f:
        parts = line.rstrip("\n").split(None, args.skip_ncols)
        prefix = parts[: args.skip_ncols]
        text = parts[args.skip_ncols] if len(parts) > args.skip_ncols else ""
        print(" ".join(prefix + [tok.encode(text)]))


def text2vocabulary(argv):
    p = argparse.ArgumentParser(prog="text2vocabulary")
    p.add_argument("--skip-ncols", type=int, default=0)
    p.add_argument("--cutoff", type=int, default=0)
    p.add_argument("--vocabsize", type=int, default=20000)
    p.add_argument("--exclude", type=str, default=None)
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--valid-text", type=str, default=None)
    p.add_argument("--test-text", type=str, default=None)
    p.add_argument("text_files", nargs="*")
    args = p.parse_args(argv)
    exclude = args.exclude.split(" ") if args.exclude else []
    counter: Counter = Counter()
    files = args.text_files or ["-"]
    for fn in files:
        f = sys.stdin if fn == "-" else open(fn, encoding="utf-8")
        for line in f:
            tokens = line.rstrip().split()[args.skip_ncols :]
            counter.update(t for t in tokens if t not in exclude)
    total = sum(counter.values())
    if args.vocab is None:
        most_common = counter.most_common(args.vocabsize)
        kept = [(w, c) for w, c in most_common if c >= max(args.cutoff, 1)]
        vocab = sorted(w for w, _ in kept)  # lexical order (prefix-tree req)
        invocab = sum(c for _, c in kept)
    else:
        with open(args.vocab, encoding="utf-8") as f:
            vocab = sorted(ln.split()[0] for ln in f if ln.strip())
        invocab = sum(counter.get(w, 0) for w in vocab)
    for w in vocab:
        print(f"{w} {counter.get(w, 1)}")
    logger.info(
        "training set OOV rate: %.2f%%", 100.0 * (1 - invocab / max(total, 1))
    )
    for name, path in (("valid", args.valid_text), ("test", args.test_text)):
        if not path:
            continue
        vset = set(vocab)
        tot = inv = 0
        for pth in path.split(":"):
            with open(pth, encoding="utf-8") as f:
                for line in f:
                    toks = line.rstrip().split()[args.skip_ncols :]
                    tot += len(toks)
                    inv += sum(t in vset for t in toks)
        logger.info("%s set OOV rate: %.2f%%", name, 100.0 * (1 - inv / max(tot, 1)))


def wav2num_frames(argv):
    p = argparse.ArgumentParser(prog="wav2num_frames")
    p.add_argument("wav_scp", nargs="?", default="-")
    args = p.parse_args(argv)
    from espresso_tpu_torch.data.audio import read_audio
    from espresso_tpu_torch.features.fbank import num_samples_to_num_frames

    f = sys.stdin if args.wav_scp == "-" else open(args.wav_scp, encoding="utf-8")
    for line in f:
        utt_id, rx = line.strip().split(None, 1)
        kind = "command" if rx.rstrip().endswith("|") else "wave"
        wav, sr = read_audio(rx, kind)
        print(utt_id, num_samples_to_num_frames(len(wav), sr))


def compute_wer(argv):
    p = argparse.ArgumentParser(prog="compute_wer")
    p.add_argument("--non-lang-syms", type=str, default=None)
    p.add_argument("--wer-output-filter", type=str, default=None)
    p.add_argument("ref_text")
    p.add_argument("hyp_text")
    args = p.parse_args(argv)
    from espresso_tpu_torch.tools.wer import Scorer

    scorer = Scorer(wer_output_filter=args.wer_output_filter)
    refs = {}
    with open(args.ref_text, encoding="utf-8") as f:
        for line in f:
            utt_id, _, text = line.rstrip("\n").partition(" ")
            refs[utt_id] = text
    with open(args.hyp_text, encoding="utf-8") as f:
        for line in f:
            utt_id, _, text = line.rstrip("\n").partition(" ")
            if utt_id in refs:
                scorer.add_evaluation(utt_id, refs[utt_id], text)
    print(scorer.result_string())
    print(f"WER: {scorer.wer():.2f}%")


def estimate_state_prior(argv):
    raise NotImplementedError(
        "prep estimate_state_prior: the hybrid task's state prior is not ported (ROADMAP queue A "
        "item 2)"
    )


def binarize(argv):
    """Binarize LM text (one sentence per line) into {prefix}.bin/.idx
    (fairseq-preprocess + MMapIndexedDataset equivalent)."""
    p = argparse.ArgumentParser(prog="binarize")
    p.add_argument("--text", required=True, help="input text file")
    p.add_argument("--dict", required=True, help="dictionary file")
    p.add_argument("--output-prefix", required=True)
    p.add_argument("--no-append-eos", action="store_true")
    args = p.parse_args(argv)
    from espresso_tpu_torch.data.dictionary import AsrDictionary
    from espresso_tpu_torch.data.indexed_dataset import MMapTokenDataset, write_binarized

    dic = AsrDictionary.load(args.dict)

    def seqs():
        with open(args.text, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield dic.encode_line(line, append_eos=not args.no_append_eos)

    n = write_binarized(args.output_prefix, seqs())
    ds = MMapTokenDataset(args.output_prefix)
    logger.info("binarized %d sentences, %d tokens -> %s.bin", n, ds.total_tokens, args.output_prefix)
    return 0


COMMANDS = {
    "asr_prep_json": asr_prep_json,
    "compute_cmvn": compute_cmvn,
    "binarize": binarize,
    "text2token": text2token,
    "text2vocabulary": text2vocabulary,
    "wav2num_frames": wav2num_frames,
    "compute_wer": compute_wer,
    "estimate_state_prior": estimate_state_prior,
}


def main(argv=None):
    # the log goes to stderr: text2token and text2vocabulary write their
    # data to stdout, which run.sh redirects into the dictionary
    setup_logging(stream=sys.stderr)
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: prep <{'|'.join(COMMANDS)}> [args]", file=sys.stderr)
        return 1
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main() or 0)
