"""Context biasing graph: Aho-Corasick trie over hotword token sequences.

A copy of ``chunkformer_tpu/decode/context_graph.py`` (plain Python). The
reference's context graph
(reference: chunkformer/utils/context_graph.py:62-271): each matched token
adds a score bonus during CTC prefix beam search; fail/output arcs back off
partial matches; `finalize` cancels the boost of unterminated partial matches.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple


class ContextState:
    """(reference: context_graph.py:62-102)"""

    __slots__ = ("id", "token", "token_score", "node_score", "output_score",
                 "is_end", "next", "fail", "output")

    def __init__(self, state_id: int, token: int, token_score: float,
                 node_score: float, output_score: float, is_end: bool):
        self.id = state_id
        self.token = token
        self.token_score = token_score
        self.node_score = node_score
        self.output_score = output_score
        self.is_end = is_end
        self.next: Dict[int, "ContextState"] = {}
        self.fail: Optional["ContextState"] = None
        self.output: Optional["ContextState"] = None


class ContextGraph:
    """(reference: context_graph.py:105-271)"""

    def __init__(self, context_list: List[List[int]], context_score: float = 6.0):
        self.context_score = context_score
        self.num_nodes = 0
        self.root = ContextState(0, -1, 0.0, 0.0, 0.0, False)
        self.root.fail = self.root
        self._build(context_list)
        self._fill_fail_output()

    @classmethod
    def from_file(cls, path: str, tokenizer, context_score: float = 6.0) -> "ContextGraph":
        phrases = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    _, ids = tokenizer.tokenize(line)
                    if ids:
                        phrases.append(ids)
        return cls(phrases, context_score)

    def _build(self, context_list: List[List[int]]) -> None:
        for tokens in context_list:
            node = self.root
            for i, token in enumerate(tokens):
                if token not in node.next:
                    self.num_nodes += 1
                    is_end = i == len(tokens) - 1
                    node_score = node.node_score + self.context_score
                    node.next[token] = ContextState(
                        self.num_nodes, token, self.context_score, node_score,
                        node_score if is_end else 0.0, is_end)
                node = node.next[token]

    def _fill_fail_output(self) -> None:
        queue = deque()
        for token, node in self.root.next.items():
            node.fail = self.root
            queue.append(node)
        while queue:
            current = queue.popleft()
            for token, node in current.next.items():
                fail = current.fail
                if token in fail.next:
                    fail = fail.next[token]
                else:
                    while token not in fail.next:
                        fail = fail.fail
                        if fail.token == -1:  # root
                            break
                    if token in fail.next:
                        fail = fail.next[token]
                node.fail = fail
                # output arc: longest proper suffix that is a full phrase
                output = node.fail
                while not output.is_end:
                    output = output.fail
                    if output.token == -1:  # root
                        output = None
                        break
                node.output = output
                node.output_score += 0.0 if output is None else output.output_score
                queue.append(node)

    def forward_one_step(self, state: ContextState, token: int) -> Tuple[float, ContextState]:
        """Returns (score_delta, next_state) (reference: context_graph.py:215-253)."""
        if token in state.next:
            node = state.next[token]
            score = node.token_score
        else:
            node = state.fail
            while token not in node.next and node is not self.root:
                node = node.fail
            if token in node.next:
                node = node.next[token]
            else:
                node = self.root
            score = node.node_score - state.node_score
        return score + node.output_score, node

    def finalize(self, state: ContextState) -> Tuple[float, ContextState]:
        """Implicit fail-to-root at sequence end: subtract the node score
        (reference: context_graph.py:256-271 — note the reference subtracts for
        terminal states too, netting a full k-token match to k*context_score
        after the terminal output bonus)."""
        if state is None:
            return 0.0, self.root
        return -state.node_score, self.root
