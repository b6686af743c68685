"""Symbol dictionary for ASR.

A copy of ``espresso_tpu/data/dictionary.py`` that the port can import: the
JAX package's ``data/__init__`` loads jax. Same specials, order and
``blank()``/``eos()``.

Rebuild of the reference's ``AsrDictionary``
(espresso/data/asr_dictionary.py:18-142 over fairseq/data/dictionary.py):
a symbol table with reserved specials, an optional ``<space>`` symbol,
non-linguistic symbols, and bos doubling as the CTC/Transducer blank
(reference espresso/tasks/speech_recognition.py:324-328).

File format is the fairseq one: ``<symbol> <count>`` per line.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class AsrDictionary:
    def __init__(
        self,
        bos: str = "<s>",
        pad: str = "<pad>",
        eos: str = "</s>",
        unk: str = "<unk>",
        space: str = "<space>",
        enable_bos: bool = False,
    ):
        self.bos_word, self.pad_word, self.eos_word, self.unk_word = bos, pad, eos, unk
        self.space_word = space
        self.symbols: List[str] = []
        self.count: List[int] = []
        self.indices: Dict[str, int] = {}
        # reference ordering: bos only added when enabled (asr_dictionary.py:35-47)
        self.bos_index = self.add_symbol(bos) if enable_bos else None
        self.pad_index = self.add_symbol(pad)
        self.eos_index = self.add_symbol(eos)
        self.unk_index = self.add_symbol(unk)
        self.nspecial = len(self.symbols)
        self.space_index: Optional[int] = None
        self.non_lang_syms: Optional[List[str]] = None
        self.tokenizer = None
        self.bpe = None

    # -- specials ---------------------------------------------------------
    def bos(self) -> int:
        assert self.bos_index is not None, "bos disabled for this dictionary"
        return self.bos_index

    def pad(self) -> int:
        return self.pad_index

    def eos(self) -> int:
        return self.eos_index

    def unk(self) -> int:
        return self.unk_index

    def space(self) -> Optional[int]:
        return self.space_index

    def blank(self) -> int:
        """Blank symbol for CTC/Transducer = bos (speech_recognition.py:324-328)."""
        return self.bos()

    # -- core table -------------------------------------------------------
    def __len__(self) -> int:
        return len(self.symbols)

    def __getitem__(self, idx: int) -> str:
        if 0 <= idx < len(self.symbols):
            return self.symbols[idx]
        return self.unk_word

    def __contains__(self, sym: str) -> bool:
        return sym in self.indices

    def index(self, sym: str) -> int:
        return self.indices.get(sym, self.unk_index)

    def add_symbol(self, word: str, n: int = 1, overwrite: bool = False) -> int:
        if word in self.indices and not overwrite:
            idx = self.indices[word]
            self.count[idx] += n
            return idx
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        self.count.append(n)
        return idx

    # -- encode / decode --------------------------------------------------
    def encode_line(
        self,
        line: str,
        append_eos: bool = True,
    ) -> np.ndarray:
        words = line.split()
        ids = [self.index(w) for w in words]
        if append_eos:
            ids.append(self.eos_index)
        return np.asarray(ids, dtype=np.int32)

    def string(
        self,
        tensor: Sequence[int],
        bpe_symbol: Optional[str] = None,
        extra_symbols_to_ignore: Optional[Iterable[int]] = None,
    ) -> str:
        ignore = {self.eos_index, self.pad_index}
        if extra_symbols_to_ignore:
            ignore.update(extra_symbols_to_ignore)
        return " ".join(self[int(i)] for i in tensor if int(i) not in ignore)

    def wordpiece_encode(self, line: str) -> str:
        """Tokenize raw text through the attached tokenizer/BPE
        (reference asr_dictionary.py:130-136)."""
        if self.tokenizer is not None:
            line = self.tokenizer.encode(line)
        if self.bpe is not None:
            line = self.bpe.encode(line)
        return line

    def wordpiece_decode(self, line: str) -> str:
        if self.bpe is not None:
            line = self.bpe.decode(line)
        if self.tokenizer is not None:
            line = self.tokenizer.decode(line)
        return line

    def tokens_to_sentence(self, line: str, use_unk_sym: bool = True) -> str:
        """Convert space-delimited token string back to words via <space>
        (reference espresso/tools/utils.py tokenize inverse)."""
        if self.bpe is not None or self.tokenizer is not None:
            return self.wordpiece_decode(line)
        tokens = line.split()
        words: List[str] = []
        cur: List[str] = []
        for tok in tokens:
            if tok == self.space_word:
                if cur:
                    words.append("".join(cur))
                    cur = []
            elif tok == self.unk_word:
                cur.append("*" if use_unk_sym else tok)
            else:
                cur.append(tok)
        if cur:
            words.append("".join(cur))
        return " ".join(words)

    # -- persistence ------------------------------------------------------
    @classmethod
    def load(
        cls,
        path: str,
        enable_bos: bool = False,
        non_lang_syms: Optional[str] = None,
    ) -> "AsrDictionary":
        d = cls(enable_bos=enable_bos)
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                try:
                    sym, cnt = line.rsplit(" ", 1)
                    cnt = int(cnt)
                except ValueError:
                    sym, cnt = line, 1
                d.add_symbol(sym, n=cnt)
        if d.space_word in d.indices:
            d.space_index = d.indices[d.space_word]
        if non_lang_syms is not None:
            with open(non_lang_syms, encoding="utf-8") as f:
                syms = [ln.strip() for ln in f if ln.strip()]
            for sym in syms:
                assert re.match(r"^[<\[].*[>\]]$", sym), (
                    f"non-linguistic symbol {sym!r} should be enclosed in <> or []"
                )
            d.non_lang_syms = syms
        return d

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for sym, cnt in zip(
                self.symbols[self.nspecial :], self.count[self.nspecial :]
            ):
                f.write(f"{sym} {cnt}\n")
