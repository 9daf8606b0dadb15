"""Constrained decoding: guided_choice tries and their device tables.

The port of the guided_choice half of ``dynamo_tpu/engine/guided.py``:
the completion must be exactly one of N token sequences (the canonical
tokenizations of the request's choices, ``guided_choice_token_ids``), held
as a token trie behind the cursor interface the scheduler drives
(``allowed() -> (ids, at_end)``, ``advance(token) -> verdict``), and the
dense device transition table the chained decode burst reads its mask
from. Guided JSON (``JsonGrammar``, ``JsonConstraint``, the tokenizer's
piece table) needs a tokenizer and belongs to a later slice.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.transfer import to_device

GUIDED_END = -1  # terminal marker key inside a guided-choice trie


def build_choice_trie(choice_ids: Sequence[Sequence[int]]) -> dict:
    """Token trie over the guided choices' canonical tokenizations:
    nested {token_id: child} dicts with GUIDED_END marking a complete
    choice (choices may be prefixes of one another)."""
    root: dict = {}
    for ids in choice_ids:
        node = root
        for t in ids:
            node = node.setdefault(int(t), {})
        node[GUIDED_END] = True
    return root


class TrieConstraint:
    """Cursor over a choice trie (one per request).

    ``path`` records the tokens consumed so far: the trie nodes are plain
    dicts without stable identities across rebuilds, so the path is the
    canonical cursor state the device-table compiler
    (``compile_device_table``) keys its state map on."""

    def __init__(self, choice_ids: Sequence[Sequence[int]]):
        self._choice_ids = choice_ids
        self.node: Optional[dict] = build_choice_trie(choice_ids)
        self.path: Tuple[int, ...] = ()

    def reset(self) -> None:
        """Back to the start (preemption-resume re-walks from scratch)."""
        self.node = build_choice_trie(self._choice_ids)
        self.path = ()

    def state_key(self):
        """Hashable signature of the cursor position: two equal keys
        imply identical allowed sets (the scheduler skips mask edits on
        no-change advances)."""
        return id(self.node)

    def allowed(self) -> Tuple[List[int], bool]:
        node = self.node or {}
        return [t for t in node if t != GUIDED_END], GUIDED_END in node

    def advance(self, token_id: int) -> str:
        node = (self.node or {}).get(int(token_id))
        if node is None:
            return "derail"
        self.node = node
        self.path = self.path + (int(token_id),)
        if not any(t != GUIDED_END for t in node):
            return "done"  # choice complete, no longer continuation
        return "ok"


# ---------------------------------------------------------------------------
# device transition tables (the guided mask inside the burst carry)
# ---------------------------------------------------------------------------
#
# The chained decode loop (``Scheduler._decode_chained``) cannot pay a host
# mask edit per token, so a BOUNDED constraint compiles to a dense device
# table ``state × token → next state`` (-1 = reject): the burst computes
# the additive mask from the current state's row and advances the per-row
# grammar-state carry on the sampled token. State 0 is the reserved DONE
# terminal: transitioning into it means the constraint completed (the
# host's ``advance`` verdict "done"), and eos ids map to it at every
# legal-end state. A constraint whose reachable state set exceeds the
# bound returns None and keeps the host sync path EXPLICITLY: the
# scheduler counts the fallback, never silently downgrades.


class DeviceGuidedTable:
    """Compiled device transition table + the host-state → id map."""

    DONE = 0  # reserved terminal state id

    def __init__(self, table, state_ids, kind: str):
        self.table = np.asarray(table, np.int32)   # [S, V]
        self.state_ids = state_ids                 # host key → state id
        self.kind = kind                           # "trie"
        self.n_states = self.table.shape[0]
        self._dev = {}                             # (bucket, device) → tensor

    def state_id(self, constraint) -> Optional[int]:
        """Table id of a live cursor's CURRENT state (None = unmapped: the
        cursor wandered somewhere the BFS never reached, which only a bug
        can produce; the scheduler falls back loudly)."""
        return self.state_ids.get(constraint.path)

    def device(self, bucket: int, device="cpu") -> torch.Tensor:
        """The table as an int32 tensor on ``device`` padded to ``bucket``
        states (rows of -1). Cached per (bucket, device): the upload
        happens once per table, not per dispatch."""
        key = (bucket, str(device))
        dev = self._dev.get(key)
        if dev is None:
            padded = np.full((max(bucket, self.n_states), self.table.shape[1]),
                             -1, np.int32)
            padded[: self.n_states] = self.table
            dev = to_device(padded, device)
            self._dev[key] = dev
        return dev


def compile_device_table(
    constraint,
    vocab_size: int,
    eos_ids: Sequence[int] = (),
    max_states: int = 256,
    budget_s: float = 2.0,
) -> Optional[DeviceGuidedTable]:
    """BFS the constraint's reachable states into a device table.

    Works on a FRESH walk of the constraint's definition (the live cursor
    is never touched). Returns None when the state set exceeds
    ``max_states`` or the sweep exceeds ``budget_s``: the caller keeps the
    request on the host sync path and names the reason. Runs on an
    executor thread, never on the event loop."""
    eos = [int(e) for e in (eos_ids or []) if 0 <= int(e) < vocab_size]
    deadline = time.monotonic() + budget_s
    if not isinstance(constraint, TrieConstraint):
        return None
    root = build_choice_trie(constraint._choice_ids)

    def expand(path):
        node = root
        for t in path:
            node = node[t]
        ids = [t for t in node if t != GUIDED_END and 0 <= t < vocab_size]
        out = []
        for t in ids:
            child = node[t]
            done = not any(k != GUIDED_END for k in child)
            out.append((t, None if done else path + (t,)))
        return out, GUIDED_END in node

    # state 0 = DONE; real states from 1
    state_ids: Dict[tuple, int] = {(): 1}
    rows: List[Optional[List[Tuple[int, Optional[tuple]]]]] = [None, None]
    at_ends: List[bool] = [False, False]
    queue = [()]
    while queue:
        if time.monotonic() > deadline:
            return None
        key = queue.pop(0)
        sid = state_ids[key]
        trans, at_end = expand(key)
        rows[sid] = trans
        at_ends[sid] = at_end
        for _t, nxt_key in trans:
            if nxt_key is None or nxt_key in state_ids:
                continue
            if len(state_ids) + 1 > max_states:
                return None
            state_ids[nxt_key] = len(state_ids) + 1
            rows.append(None)
            at_ends.append(False)
            queue.append(nxt_key)

    n = len(state_ids) + 1
    table = np.full((n, vocab_size), -1, np.int32)
    for key, sid in state_ids.items():
        for t, nxt_key in rows[sid]:
            table[sid, t] = (
                DeviceGuidedTable.DONE if nxt_key is None
                else state_ids[nxt_key]
            )
        if at_ends[sid]:
            for e in eos:
                table[sid, e] = DeviceGuidedTable.DONE
    return DeviceGuidedTable(table, dict(state_ids), "trie")
