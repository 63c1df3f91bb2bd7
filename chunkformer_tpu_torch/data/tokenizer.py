"""Tokenizers (counterpart of ``chunkformer_tpu/data/tokenizer.py``; reference
chunkformer/text/*.py).

- ``CharTokenizer``: character level, with non-language symbols and the
  ``▁`` space marker (reference: text/char_tokenizer.py). A copy of the JAX
  package's.
- ``BpeTokenizer``: sentencepiece when it is installed (imported only on
  first use), else a greedy longest match over the symbol table.
- ``build_tokenizer``: the factory of the train CLI.

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
    def __init__(self, symbol_table: Dict[str, int], bpe_model: Optional[str] = None,
                 non_lang_syms: Optional[List[str]] = None):
        self.symbol_table = symbol_table
        self.char_dict = {v: k for k, v in symbol_table.items()}
        self.non_lang_syms = non_lang_syms or []
        self._bpe_model_path = bpe_model
        self._sp = None  # loaded on first use, so worker processes load their own

    def _ensure_sp(self):
        if self._sp is None and self._bpe_model_path:
            try:
                import sentencepiece as spm

                self._sp = spm.SentencePieceProcessor()
                self._sp.load(self._bpe_model_path)
            except ImportError:
                self._sp = False
        return self._sp

    def text2tokens(self, line: str) -> List[str]:
        sp = self._ensure_sp()
        if sp:
            return sp.encode_as_pieces(line.strip())
        return self._greedy_bpe(line.strip())

    def _greedy_bpe(self, line: str) -> List[str]:
        """Longest-match fallback over the symbol table."""
        tokens: List[str] = []
        for word in line.split():
            piece = "▁" + word
            while piece:
                for end in range(len(piece), 0, -1):
                    if piece[:end] in self.symbol_table:
                        tokens.append(piece[:end])
                        piece = piece[end:]
                        break
                else:
                    tokens.append("<unk>")
                    piece = piece[1:]
        return tokens

    def tokens2text(self, tokens: Sequence[str]) -> str:
        return "".join(tokens).replace("▁", " ").strip()


def build_tokenizer(tokenizer: str, conf: Dict) -> BaseTokenizer:
    """Factory (reference: utils/init_tokenizer.py:23-45)."""
    from ..api import read_symbol_table

    table = read_symbol_table(conf["symbol_table_path"])
    nls = None
    if conf.get("non_lang_syms_path"):
        with open(conf["non_lang_syms_path"]) as f:
            nls = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    if tokenizer == "bpe":
        return BpeTokenizer(table, conf.get("bpe_path"), nls)
    return CharTokenizer(table, nls, conf.get("split_with_space", False))
