"""Constrained decoding: guided_choice tries and guided JSON grammars.

The port of ``dynamo_tpu/engine/guided.py``. Two constraint families behind
one cursor interface the scheduler drives (``allowed() -> (ids, at_end)``,
``advance(token) -> verdict``, ``state_key()``, ``reset()``):

- ``TrieConstraint``: the completion must be exactly one of N token
  sequences (the canonical tokenizations of the request's choices,
  ``guided_choice_token_ids``, which the preprocessor tokenizes), held as a
  token trie.
- ``JsonConstraint``: the completion must be valid JSON
  (``response_format={"type": "json_object"}``) or validate against a
  JSON-schema subset (``json_schema``: object/required, string, number,
  integer, boolean, null, enum, array), walked by a character-level
  pushdown machine over IMMUTABLE state tuples (``JsonGrammar``; the
  tuples are the reference's, element for element). The token mask of a
  machine state is computed once, by walking every vocabulary piece
  (``build_piece_table``) through the machine, and kept in the grammar's
  mask cache, which is an LRU over states (``MASK_CACHE_STATES``) behind a
  lock: the reference's grows without bound, and a device-table compile on
  an executor thread shares the grammar with the scheduler's loop.

``compile_device_table`` compiles a bounded constraint of either family
into the dense transition table the chained decode burst reads its mask
from.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.transfer import to_device

GUIDED_END = -1  # terminal marker key inside a guided-choice trie

_WS = " \t\n\r"
_DIGITS = "0123456789"
_HEX = "0123456789abcdefABCDEF"
# number sub-states after which the number may legally end
_NUM_CAN_END = ("int0", "int", "frac", "exp")


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
# schema compilation
# ---------------------------------------------------------------------------

_UNSUPPORTED_KEYS = (
    "pattern", "format", "minLength", "maxLength", "minimum", "maximum",
    "exclusiveMinimum", "exclusiveMaximum", "multipleOf", "minItems",
    "maxItems", "uniqueItems", "minProperties", "maxProperties",
    "oneOf", "anyOf", "allOf", "not", "if", "then", "else", "$ref",
    "patternProperties", "additionalItems", "const",
)


def _trie_has_unused(node: dict, used) -> bool:
    """Any terminal under ``node`` naming a property not yet used?"""
    for k, v in node.items():
        if k == GUIDED_END:
            if v not in used:
                return True
        elif _trie_has_unused(v, used):
            return True
    return False


def _char_trie(words: Sequence[str]) -> dict:
    """{char: child} trie; GUIDED_END→word marks a complete word."""
    root: dict = {}
    for w in words:
        node = root
        for ch in w:
            node = node.setdefault(ch, {})
        node[GUIDED_END] = w
    return root


def compile_schema(schema) -> List[dict]:
    """JSON-schema subset → a node list (node 0 is the root).

    Every keyword that cannot be ENFORCED raises ValueError (with the
    reference's message): silently ignoring e.g. ``pattern`` would emit
    outputs that fail the caller's own validation. Annotation keywords
    (title/description/default/examples) pass."""
    nodes: List[dict] = []

    def add(node: dict) -> int:
        nodes.append(node)
        return len(nodes) - 1

    def walk(s) -> int:
        if s is True or s == {}:
            return add({"kind": "any"})
        if not isinstance(s, dict):
            raise ValueError(f"unsupported schema {s!r}")
        for k in _UNSUPPORTED_KEYS:
            if k in s:
                raise ValueError(
                    f"json_schema keyword {k!r} is not supported by "
                    "guided decoding on this server")
        if "enum" in s:
            vals = s["enum"]
            if not isinstance(vals, list) or not vals:
                raise ValueError("enum must be a non-empty list")
            for v in vals:
                if not isinstance(v, (str, int, float, bool)) and v is not None:
                    raise ValueError(
                        "enum values must be scalars (string/number/"
                        "boolean/null)")
            return add({"kind": "enum",
                        "trie": _char_trie([json.dumps(v) for v in vals])})
        t = s.get("type")
        if isinstance(t, list):
            raise ValueError("union 'type' lists are not supported")
        if t == "object" or (t is None and "properties" in s):
            props = s.get("properties")
            if props is None:
                if s.get("required"):
                    # 'required' without 'properties' cannot be enforced by
                    # the key machine: never silently drop a constraint
                    raise ValueError(
                        "'required' without 'properties' is not "
                        "supported by guided decoding on this server")
                return add({"kind": "anyobj"})
            if not isinstance(props, dict) or not props:
                raise ValueError("'properties' must be a non-empty object")
            for name in props:
                # keys are walked through the trie as RAW characters: names
                # that need JSON string escaping would either emit
                # unparseable text or dead-end mid-key
                if (not isinstance(name, str) or not name
                        or any(c in '"\\' or c < " " for c in name)):
                    raise ValueError(
                        f"property name {name!r} needs JSON string "
                        "escaping, which guided decoding does not "
                        "support in schema keys")
            nid = add({})  # reserve: children may reference forward
            required = s.get("required", [])
            if not isinstance(required, list) or not set(required) <= set(props):
                raise ValueError("'required' must list property names")
            nodes[nid] = {
                "kind": "object",
                "props": {k: walk(v) for k, v in props.items()},
                "keytrie": _char_trie(list(props)),
                "required": frozenset(required),
            }
            return nid
        if t == "array":
            nid = add({})
            nodes[nid] = {"kind": "array", "items": walk(s.get("items", True))}
            return nid
        if t in ("string", "number", "integer", "boolean", "null"):
            return add({"kind": t})
        if t is None:
            return add({"kind": "any"})
        raise ValueError(f"unsupported schema type {t!r}")

    walk(schema)
    return nodes


# ---------------------------------------------------------------------------
# the character machine
# ---------------------------------------------------------------------------
#
# state = ((stack, mode), ws_run)
#   stack frames: ("o", node_id|None, used: tuple[str,...], pending|None)
#                 ("a", items_node_id|None)
#   modes: ("val", node_id|None)        value start (ws ok)
#          ("objval", None)             json_object's top level: an object
#          ("aval0", node_id|None)      after '[': value or ']'
#          ("post",)                    value done: ws , } ]
#          ("key0",) ("key1",)          object: expect key (key0 also })
#          ("kstr", esc, pos|None)      in key string (None = free-form key)
#          ("colon",)                   between key and ':'
#          ("str", esc)                 in value string; esc: 0 plain,
#                                       1 after backslash, 2..5 hex left
#          ("num", ns, is_int)          ns per _NUM_TABLE
#          ("lit", word, i)             inside true/false/null
#          ("enum", node_id, pos)       walking an enum trie; pos = tuple
#                                       of chars consumed (trie path)
#          ("end",)                     top-level value complete


class JsonGrammar:
    """Compiled constraint shared by every request with the same spec: the
    schema nodes, the vocabulary piece table, and the state → mask cache
    (an LRU of ``MASK_CACHE_STATES`` states under a lock)."""

    # structural whitespace (between tokens of the JSON grammar) is bounded
    # per run: without a cap, greedy decoding on a weak model can legally
    # emit indentation forever and never close the value. In-string
    # whitespace is content and stays unbounded.
    MAX_WS_RUN = 3
    _WS_STRUCTURAL = frozenset(
        ("val", "objval", "aval0", "post", "key0", "key1", "colon", "end"))
    # the mask cache's bound: a state's mask can hold nearly every id of
    # the vocabulary (string bodies), so the states a long-lived grammar
    # visits must not accumulate without limit
    MASK_CACHE_STATES = 256

    def __init__(self, pieces: Sequence[Optional[str]],
                 schema: Optional[dict] = None, max_depth: int = 16):
        self.pieces = pieces
        self.max_depth = max_depth
        self.nodes = compile_schema(schema) if schema is not None else None
        self._mask_cache: "OrderedDict[tuple, List[int]]" = OrderedDict()
        self._lock = threading.Lock()
        # first character → the ids of the sweepable pieces starting with
        # it, ascending: a state rejects most first characters, and every
        # piece behind a rejected one is skipped without a walk
        by_first: Dict[str, List[int]] = {}
        for tid, piece in enumerate(pieces):
            if not piece or "�" in piece:
                continue  # specials / partial-UTF8 byte tokens
            by_first.setdefault(piece[0], []).append(tid)
        self._by_first = by_first

    # -- machine ----------------------------------------------------------

    def initial(self) -> tuple:
        root = 0 if self.nodes is not None else None
        if self.nodes is None:
            # json_object: the reply must BE an object (OpenAI semantics),
            # but everything nested inside is free-form JSON
            return (((), ("objval", None)), 0)
        return (((), ("val", root)), 0)

    def step(self, state: tuple, ch: str) -> Optional[tuple]:
        """One character over the FULL state ``(core, ws_run)``; None = the
        character is illegal here (including a structural-whitespace run
        past MAX_WS_RUN)."""
        core, ws = state
        nxt = self._step_core(core, ch)
        if nxt is None:
            return None
        if ch in _WS and nxt == core and core[1][0] in self._WS_STRUCTURAL:
            return None if ws >= self.MAX_WS_RUN else (core, ws + 1)
        return (nxt, 0)

    def _node(self, nid) -> dict:
        return self.nodes[nid] if nid is not None and self.nodes else {"kind": "any"}

    def _start_value(self, stack, nid, ch):
        """Dispatch a value's first character under schema node ``nid``."""
        kind = self._node(nid)["kind"] if nid is not None else "any"
        if ch in _WS:
            return None  # the caller keeps the current mode for ws
        if kind == "enum":
            trie = self._node(nid)["trie"]
            if ch in trie:
                return self._enum_step(stack, nid, (ch,))
            return None
        ok_obj = kind in ("any", "object", "anyobj")
        ok_arr = kind in ("any", "array")
        ok_str = kind in ("any", "string")
        ok_num = kind in ("any", "number", "integer")
        ok_true = kind in ("any", "boolean")
        ok_null = kind in ("any", "null")
        if ch == "{" and ok_obj and len(stack) < self.max_depth:
            oid = nid if kind == "object" else None
            return (stack + (("o", oid, (), None),), ("key0",))
        if ch == "[" and ok_arr and len(stack) < self.max_depth:
            items = self._node(nid)["items"] if kind == "array" else None
            return (stack + (("a", items),), ("aval0", items))
        if ch == '"' and ok_str:
            return (stack, ("str", 0))
        if ok_num:
            is_int = kind == "integer"
            if ch == "-":
                return (stack, ("num", "sign", is_int))
            if ch == "0":
                return (stack, ("num", "int0", is_int))
            if ch in "123456789":
                return (stack, ("num", "int", is_int))
        if ch == "t" and ok_true:
            return (stack, ("lit", "true", 1))
        if ch == "f" and ok_true:
            return (stack, ("lit", "false", 1))
        if ch == "n" and ok_null:
            return (stack, ("lit", "null", 1))
        return None

    @staticmethod
    def _finish_value(stack) -> tuple:
        if not stack:
            return ((), ("end",))
        return (stack, ("post",))

    def _enum_step(self, stack, nid, pos) -> Optional[tuple]:
        node = self._node(nid)["trie"]
        for ch in pos:
            node = node.get(ch)
            if node is None:
                return None
        if not any(k != GUIDED_END for k in node):
            # childless terminal: the enum value is complete right here (a
            # terminal WITH children, "a" prefixing "ab", stays open; the
            # next char or an eos resolves it)
            return self._finish_value(stack)
        return (stack, ("enum", nid, pos))

    def _step_core(self, state: tuple, ch: str) -> Optional[tuple]:
        """One character over the core ``(stack, mode)`` state; None = the
        character is illegal here."""
        stack, mode = state
        m = mode[0]

        if m == "end":
            return state if ch in _WS else None

        if m in ("val", "objval", "aval0"):
            if ch in _WS:
                return state
            if m == "aval0" and ch == "]":
                return self._finish_value(stack[:-1])
            if m == "objval":
                # top level of json_object: the value must be an object
                if ch == "{":
                    return (stack + (("o", None, (), None),), ("key0",))
                return None
            return self._start_value(stack, mode[1], ch)

        if m == "post":
            if ch in _WS:
                return state
            if not stack:
                return None
            top = stack[-1]
            if top[0] == "o":
                if ch == ",":
                    node = self._node(top[1])
                    if (node.get("kind") == "object"
                            and set(node["props"]) <= set(top[2])):
                        return None  # every property used: must close
                    return (stack, ("key1",))
                if ch == "}":
                    node = self._node(top[1])
                    if (node.get("kind") == "object"
                            and not node["required"] <= set(top[2])):
                        return None  # required keys still missing
                    return self._finish_value(stack[:-1])
            else:  # array
                if ch == ",":
                    return (stack, ("val", top[1]))
                if ch == "]":
                    return self._finish_value(stack[:-1])
            return None

        if m in ("key0", "key1"):
            if ch in _WS:
                return state
            top = stack[-1]
            if ch == "}" and m == "key0":
                node = self._node(top[1])
                if node.get("kind") == "object" and node["required"]:
                    return None  # an empty object misses required keys
                return self._finish_value(stack[:-1])
            if ch == '"':
                node = self._node(top[1])
                if node.get("kind") == "object":
                    if not _trie_has_unused(node["keytrie"], top[2]):
                        return None  # no unused property left to name
                    return (stack, ("kstr", 0, ()))
                return (stack, ("kstr", 0, None))
            return None

        if m == "kstr":
            esc, pos = mode[1], mode[2]
            if pos is None:  # free-form key: the full string grammar
                nxt = self._str_char(esc, ch)
                if nxt is None:
                    return None
                if nxt == "close":
                    return (stack, ("colon",))
                return (stack, ("kstr", nxt, None))
            # schema keys: plain chars walked through the property trie
            top = stack[-1]
            cur = self._node(top[1])["keytrie"]
            for c in pos:
                cur = cur[c]
            if ch == '"':
                name = cur.get(GUIDED_END)
                if name is None or name in top[2]:
                    return None  # not a property / already used
                frame = ("o", top[1], top[2], name)
                return (stack[:-1] + (frame,), ("colon",))
            if ch in cur and _trie_has_unused(cur[ch], top[2]):
                # only descend branches that still lead to an UNUSED
                # property: walking into "name" twice would dead-end at
                # the closing quote with no legal continuation
                return (stack, ("kstr", 0, pos + (ch,)))
            return None

        if m == "colon":
            if ch in _WS:
                return state
            if ch != ":":
                return None
            top = stack[-1]
            node = self._node(top[1])
            if node.get("kind") == "object":
                name = top[3]
                frame = ("o", top[1], tuple(sorted(set(top[2]) | {name})), None)
                return (stack[:-1] + (frame,), ("val", node["props"][name]))
            return (stack, ("val", None))

        if m == "str":
            nxt = self._str_char(mode[1], ch)
            if nxt is None:
                return None
            if nxt == "close":
                return self._finish_value(stack)
            return (stack, ("str", nxt))

        if m == "num":
            return self._num_char(stack, mode[1], ch, mode[2])

        if m == "lit":
            word, i = mode[1], mode[2]
            if ch != word[i]:
                return None
            if i + 1 == len(word):
                return self._finish_value(stack)
            return (stack, ("lit", word, i + 1))

        if m == "enum":
            nid, pos = mode[1], mode[2]
            cur = self._node(nid)["trie"]
            for c in pos:
                cur = cur[c]
            if ch in cur:
                return self._enum_step(stack, nid, pos + (ch,))
            if GUIDED_END in cur:
                # value complete; the char belongs to the enclosing context
                # (",", "}", ws, ...)
                return self._step_core(self._finish_value(stack), ch)
            return None

        raise AssertionError(f"unknown mode {mode!r}")

    @staticmethod
    def _str_char(esc: int, ch: str):
        """String-body char: the next esc sub-state, "close", or None. esc:
        0 plain, 1 after backslash, 2..5 = hex digits left."""
        if esc == 0:
            if ch == '"':
                return "close"
            if ch == "\\":
                return 1
            if "\x00" <= ch <= "\x1f":
                return None  # control chars must be escaped
            return 0
        if esc == 1:
            if ch == "u":
                return 5
            if ch in '"\\/bfnrt':
                return 0
            return None
        if ch in _HEX:
            return 0 if esc == 2 else esc - 1
        return None

    _NUM_TABLE = {
        "sign": {"0": "int0", **{d: "int" for d in "123456789"}},
        "int0": {".": "dot", "e": "e", "E": "e"},
        "int": {**{d: "int" for d in _DIGITS}, ".": "dot", "e": "e", "E": "e"},
        "dot": {d: "frac" for d in _DIGITS},
        "frac": {**{d: "frac" for d in _DIGITS}, "e": "e", "E": "e"},
        "e": {"+": "esign", "-": "esign", **{d: "exp" for d in _DIGITS}},
        "esign": {d: "exp" for d in _DIGITS},
        "exp": {d: "exp" for d in _DIGITS},
    }

    def _num_char(self, stack, ns: str, ch: str,
                  is_int: bool) -> Optional[tuple]:
        nxt = self._NUM_TABLE[ns].get(ch)
        if nxt is not None:
            if is_int and nxt in ("dot", "e"):
                return None  # integer schema: no fraction, no exponent
            return (stack, ("num", nxt, is_int))
        if ns in _NUM_CAN_END:
            # the number ends before this char; reprocess it one level up
            return self._step_core(self._finish_value(stack), ch)
        return None

    # -- token masks -------------------------------------------------------

    def run_piece(self, state: tuple, piece: str) -> Optional[tuple]:
        for ch in piece:
            state = self.step(state, ch)
            if state is None:
                return None
        return state

    def transitions(self, state: tuple) -> List[Tuple[int, tuple]]:
        """``(token id, state after its piece)`` for every id whose full
        piece is legal from ``state``, ids ascending: the reference's
        per-piece ``run_piece`` sweep, computed over the machine's states
        instead. ``step`` is a function of (state, char) alone, so each
        distinct (state, char) pair is stepped once a sweep and every piece
        walks a table of the states it reaches; pieces whose first
        character the state rejects are never walked."""
        pieces = self.pieces
        states = [state]
        index = {state: 0}
        trans: List[Dict[str, int]] = [{}]
        tids: List[int] = []
        ends: List[int] = []

        def advance(sid: int, ch: str) -> int:
            nxt = self.step(states[sid], ch)
            if nxt is None:
                out = -1
            else:
                out = index.get(nxt)
                if out is None:
                    out = index[nxt] = len(states)
                    states.append(nxt)
                    trans.append({})
            trans[sid][ch] = out
            return out

        for ch0, group in self._by_first.items():
            sid0 = advance(0, ch0)
            if sid0 < 0:
                continue
            for tid in group:
                sid = sid0
                it = iter(pieces[tid])
                next(it)
                for ch in it:
                    nxt = trans[sid].get(ch)
                    if nxt is None:
                        nxt = advance(sid, ch)
                    if nxt < 0:
                        break
                    sid = nxt
                else:
                    tids.append(tid)
                    ends.append(sid)
        order = np.argsort(np.asarray(tids, np.int64), kind="stable")
        return [(tids[i], states[ends[i]]) for i in order.tolist()]

    def allowed_tokens(self, state: tuple) -> List[int]:
        """Token ids whose full piece string is legal from ``state``. Cached
        per state in the LRU: two requests in the same parser situation, or
        one request revisiting it (successive string-body tokens), share
        the sweep."""
        with self._lock:
            cached = self._mask_cache.get(state)
            if cached is not None:
                self._mask_cache.move_to_end(state)
                return cached
        # swept outside the lock: a table compile on an executor thread
        # must not hold the scheduler's loop behind its sweep
        ids = [tid for tid, _ in self.transitions(state)]
        with self._lock:
            cached = self._mask_cache.get(state)
            if cached is not None:  # another thread swept it meanwhile
                self._mask_cache.move_to_end(state)
                return cached
            self._mask_cache[state] = ids
            while len(self._mask_cache) > self.MASK_CACHE_STATES:
                self._mask_cache.popitem(last=False)
            return ids

    def at_end(self, state: tuple) -> bool:
        (stack, mode), _ws = state
        if mode[0] == "end":
            return True
        # a top-level number (or an enum at a terminal that prefixes a
        # longer value) can only terminate on eos: there is no closing
        # delimiter to advance the machine
        if not stack and mode[0] == "num" and mode[1] in _NUM_CAN_END:
            return True
        if not stack and mode[0] == "enum":
            cur = self._node(mode[1])["trie"]
            for c in mode[2]:
                cur = cur[c]
            return GUIDED_END in cur
        return False


class JsonConstraint:
    """Per-request cursor over a shared JsonGrammar."""

    def __init__(self, grammar: JsonGrammar):
        self.grammar = grammar
        self.state = grammar.initial()

    def reset(self) -> None:
        """Back to the start (preemption-resume re-walks from scratch)."""
        self.state = self.grammar.initial()

    def state_key(self):
        """Hashable signature of the machine state: equal keys imply
        identical allowed sets. String-body tokens typically leave the
        state unchanged, so the steady state skips the per-token mask
        edit."""
        return self.state

    def allowed(self) -> Tuple[List[int], bool]:
        return (self.grammar.allowed_tokens(self.state),
                self.grammar.at_end(self.state))

    def advance(self, token_id: int) -> str:
        pieces = self.grammar.pieces
        piece = pieces[token_id] if 0 <= token_id < len(pieces) else None
        if not piece:
            return "derail"
        nxt = self.grammar.run_piece(self.state, piece)
        if nxt is None:
            return "derail"
        self.state = nxt
        return "done" if nxt[0][1][0] == "end" else "ok"


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
        self.kind = kind                           # "trie" | "json"
        self.n_states = self.table.shape[0]
        self._dev = {}                             # (bucket, device) → tensor

    def state_id(self, constraint) -> Optional[int]:
        """Table id of a live cursor's CURRENT state (None = unmapped: the
        cursor wandered somewhere the BFS never reached, which only a bug
        can produce; the scheduler falls back loudly)."""
        key = (constraint.path if isinstance(constraint, TrieConstraint)
               else constraint.state)
        return self.state_ids.get(key)

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
    if isinstance(constraint, TrieConstraint):
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

        start_key, kind = (), "trie"
    elif isinstance(constraint, JsonConstraint):
        grammar = constraint.grammar

        def expand(state):
            # the sweep's own next states: run_piece's, without a second
            # walk of every legal piece
            trans = [(t, nxt) for t, nxt in grammar.transitions(state)
                     if 0 <= t < vocab_size]
            out = [(t, None if nxt[0][1][0] == "end" else nxt)
                   for t, nxt in trans]
            return out, grammar.at_end(state)

        start_key, kind = grammar.initial(), "json"
    else:
        return None

    # state 0 = DONE; real states from 1
    state_ids: Dict[tuple, int] = {start_key: 1}
    rows: List[Optional[List[Tuple[int, Optional[tuple]]]]] = [None, None]
    at_ends: List[bool] = [False, False]
    queue = [start_key]
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
    return DeviceGuidedTable(table, dict(state_ids), kind)


def build_piece_table(tokenizer, vocab_size: int) -> List[Optional[str]]:
    """The exact text each token id appends to a decode stream.

    ``decode([id])`` alone can drop a leading space (decoder cleanup is
    applied at sequence start), so the piece is recovered from the SECOND
    occurrence in ``decode([id, id])``: mid-sequence rendering is what
    concatenative masking must model. Specials decode to ""
    (skip_special_tokens) → None → banned from every mask; partial-UTF8
    byte tokens carry U+FFFD and are banned by the grammar sweep."""
    pieces: List[Optional[str]] = [None] * vocab_size
    tv = tokenizer.vocab_size
    n = min(vocab_size, tv() if callable(tv) else tv)
    for i in range(n):
        try:
            p1 = tokenizer.decode([i])
        except Exception:
            continue
        if not p1:
            continue
        try:
            p2 = tokenizer.decode([i, i])
        except Exception:
            pieces[i] = p1
            continue
        pieces[i] = p2[len(p1):] if p2 != p1 + p1 and len(p2) > len(p1) else p1
    return pieces
