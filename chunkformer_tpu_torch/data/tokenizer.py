"""Tokenizers (counterpart of ``chunkformer_tpu/data/tokenizer.py``; reference
chunkformer/text/*.py).

- ``CharTokenizer``: character level, with non-language symbols and the
  ``▁`` space marker (reference: text/char_tokenizer.py). A copy of the JAX
  package's.
- ``BpeTokenizer``: sentencepiece-backed in the JAX package; not ported yet
  (ROADMAP A16), and it raises.

The symbol table is the published vocab.txt (``symbol id`` lines,
reference: utils/file_utils.py:62-80).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple


class BaseTokenizer:
    def tokenize(self, line: str) -> Tuple[List[str], List[int]]:
        tokens = self.text2tokens(line)
        return tokens, self.tokens2ids(tokens)

    def detokenize(self, ids: Sequence[int]) -> Tuple[str, List[str]]:
        tokens = self.ids2tokens(ids)
        return self.tokens2text(tokens), tokens

    def text2tokens(self, line: str) -> List[str]:
        raise NotImplementedError

    def tokens2text(self, tokens: Sequence[str]) -> str:
        raise NotImplementedError

    def tokens2ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.symbol_table.get(t, self.symbol_table.get("<unk>", 1))
                for t in tokens]

    def ids2tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.char_dict[i] for i in ids if i in self.char_dict]

    @property
    def vocab_size(self) -> int:
        return len(self.symbol_table)


class CharTokenizer(BaseTokenizer):
    def __init__(self, symbol_table: Dict[str, int],
                 non_lang_syms: Optional[List[str]] = None,
                 split_with_space: bool = False, connect_symbol: str = ""):
        self.symbol_table = symbol_table
        self.char_dict = {v: k for k, v in symbol_table.items()}
        self.non_lang_syms = non_lang_syms or []
        self.split_with_space = split_with_space
        self.connect_symbol = connect_symbol
        pattern = "|".join(re.escape(s) for s in self.non_lang_syms) or r"(?!x)x"
        self._nls_pattern = re.compile(f"({pattern})")

    def text2tokens(self, line: str) -> List[str]:
        line = line.strip()
        parts = self._nls_pattern.split(line)
        tokens: List[str] = []
        for part in parts:
            if part in self.non_lang_syms:
                tokens.append(part)
                continue
            if self.split_with_space:
                for w in part.split():
                    tokens.append(w)
            else:
                for ch in part:
                    tokens.append("▁" if ch == " " else ch)
        return tokens

    def tokens2text(self, tokens: Sequence[str]) -> str:
        return self.connect_symbol.join(tokens).replace("▁", " ").strip()


class BpeTokenizer(BaseTokenizer):
    """Not ported yet: the JAX package's BPE tokenizer needs sentencepiece."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("BpeTokenizer is not ported yet (ROADMAP A16)")
