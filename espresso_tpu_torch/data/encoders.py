"""Tokenizers / subword encoders.

The port's own copy of ``espresso_tpu/data/encoders.py``; SentencePiece,
sacremoses and transformers are imported only when their tokenizer is
built.

Rebuild of fairseq/data/encoders + espresso/data/encoders/characters_asr.py:31:
the char tokenizer inserts ``<space>`` between words (with optional trailing
space needed by the look-ahead word LM to detect word boundaries), and a
sentencepiece wrapper is provided when the package is available.
"""

from __future__ import annotations

from typing import Optional

from espresso_tpu_torch.registry import TOKENIZERS


@TOKENIZERS.register("characters_asr")
class CharactersAsr:
    """Char-level tokenization with <space> separators
    (espresso/data/encoders/characters_asr.py)."""

    def __init__(self, space_symbol: str = "<space>", ends_with_space: bool = True):
        self.space_symbol = space_symbol
        self.ends_with_space = ends_with_space

    def encode(self, line: str) -> str:
        words = line.strip().split()
        chars = f" {self.space_symbol} ".join(" ".join(list(w)) for w in words)
        if self.ends_with_space:
            chars += f" {self.space_symbol}"
        return chars

    def decode(self, line: str) -> str:
        tokens = line.strip().split()
        words, cur = [], []
        for tok in tokens:
            if tok == self.space_symbol:
                if cur:
                    words.append("".join(cur))
                cur = []
            else:
                cur.append(tok)
        if cur:
            words.append("".join(cur))
        return " ".join(words)


@TOKENIZERS.register("sentencepiece")
class SentencepieceBPE:
    def __init__(self, model_path: str):
        try:
            import sentencepiece as spm
        except ImportError as e:
            raise ImportError("sentencepiece not available in this image") from e
        self.sp = spm.SentencePieceProcessor()
        self.sp.Load(model_path)

    def encode(self, line: str) -> str:
        return " ".join(self.sp.EncodeAsPieces(line))

    def decode(self, line: str) -> str:
        return self.sp.DecodePieces(line.split())


def build_tokenizer(name: Optional[str], **kwargs):
    if name is None:
        return None
    return TOKENIZERS.build(name, **kwargs)


@TOKENIZERS.register("moses")
class MosesTokenizer:
    """Moses tokenization via sacremoses (fairseq/data/encoders/
    moses_tokenizer.py); gated on the package being installed."""

    def __init__(self, source_lang: str = "en", target_lang: str = "en"):
        try:
            from sacremoses import MosesDetokenizer, MosesTokenizer as _MT
        except ImportError as e:
            raise ImportError("sacremoses not available in this image") from e
        self.tok = _MT(source_lang)
        self.detok = MosesDetokenizer(target_lang)

    def encode(self, line: str) -> str:
        return self.tok.tokenize(line, return_str=True)

    def decode(self, line: str) -> str:
        return self.detok.detokenize(line.split())


@TOKENIZERS.register("gpt2")
class GPT2BPE:
    """GPT-2 byte-level BPE via HuggingFace tokenizers (fairseq/data/
    encoders/gpt2_bpe.py equivalent); emits space-separated token ids
    (fairseq convention) so the Dictionary maps them to symbols."""

    def __init__(self, pretrained: str = "gpt2"):
        try:
            from transformers import GPT2Tokenizer
        except ImportError as e:
            raise ImportError("transformers not available") from e
        self.bpe = GPT2Tokenizer.from_pretrained(pretrained)

    def encode(self, line: str) -> str:
        return " ".join(str(i) for i in self.bpe.encode(line))

    def decode(self, line: str) -> str:
        return self.bpe.decode([int(t) for t in line.split() if t.isdigit()])
