"""Constrained decoding: grammars compiled to token-level automata
that emit packed vocab bitmasks.

The port's copy of ``paddle_tpu/inference/constrain.py``, pure host
numpy, kept bit for bit: for the same grammar and vocabulary every
packed row equals the reference's.

The contract in one paragraph: a :class:`GrammarConstraint` describes
WHAT token sequences are legal (a set of allowed tokens, a regex, a
JSON schema); ``compile(vocab_size, eos_id, vocab=...)`` lowers it —
once, cached — to a :class:`CompiledGrammar`, a token-level DFA whose
states each own a packed ``ceil(V/32)`` int32 bitmask (bit t set =
token t legal next). A :class:`ConstraintState` is the per-request
cursor over that DFA: ``mask_row()`` reads the current state's mask,
``advance(token)`` steps it (returning the NEXT mask row, or ``None``
when the grammar has dead-ended). Everything here is HOST-side numpy —
the serving engine ships the rows as runtime arguments of its compiled
programs (``serving.py`` folds ``mask ? logit : -inf`` in the sampler),
so no grammar, schema or vocabulary change can ever fork an executable.

Masks are packed little-endian within each int32 lane: token ``t``
lives at bit ``t % 32`` of lane ``t // 32``. A row of all ``-1``
(every bit set) is the identity — unconstrained slots ride the same
fused ``where`` at zero semantic cost. EOS handling is part of the
contract: the mask includes the engine's EOS bit exactly when the
automaton state is ACCEPTING, so a finished grammar can stop (and a
state that accepts but cannot extend forces EOS). A state that neither
accepts nor extends is a DEAD END — ``advance`` reports it and the
engine retires the request (``finish_reason="constraint_dead_end"``),
never crashes and never ships an all-zero row to the device (an
all-``-inf`` softmax is a NaN factory).

Character-level grammars (regex, JSON schema) need a token→string
vocabulary. Pass ``vocab=`` (a list of V strings) or rely on the
default BYTE vocabulary (token i ↔ ``chr(i)``) that matches the
byte-level test models (``gpt_tiny`` V=256). Token legality is decided
by walking each token's characters through the character DFA via a
shared prefix TRIE over the vocabulary — tokens sharing a prefix share
the walk — and the per-state result (mask + token transitions) is
memoized, so steady-state stepping is two dict lookups per token.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "GrammarConstraint", "AllowedTokens", "RegexConstraint",
    "JsonSchemaConstraint", "CompiledGrammar", "ConstraintState",
    "from_response_format", "identity_row", "pack_token_ids",
    "token_in_row",
]


# -- packed-row helpers ------------------------------------------------------

def mask_width(vocab_size: int) -> int:
    """Lanes per row: ``ceil(V / 32)``."""
    return (int(vocab_size) + 31) // 32


def identity_row(vocab_size: int) -> np.ndarray:
    """The all-ones row (every token legal) — int32 ``-1`` per lane.

    Bits past V in the last lane are set too; they address tokens that
    do not exist, and the sampler's unpack never reads them (the
    ``arange(V)`` gather stops at V), so leaving them hot keeps the
    identity row a single constant.
    """
    return np.full((mask_width(vocab_size),), -1, dtype=np.int32)


def pack_token_ids(tokens: Iterable[int], vocab_size: int) -> np.ndarray:
    """Pack a set of token ids into one ``(W,)`` int32 row."""
    row = np.zeros((mask_width(vocab_size),), dtype=np.uint32)
    V = int(vocab_size)
    for t in tokens:
        t = int(t)
        if 0 <= t < V:
            row[t >> 5] |= np.uint32(1) << np.uint32(t & 31)
    return row.view(np.int32)


def token_in_row(row: np.ndarray, token: int) -> bool:
    """Bit test against a packed row (host-side validity checks)."""
    t = int(token)
    lane = int(np.asarray(row).view(np.uint32)[t >> 5])
    return bool((lane >> (t & 31)) & 1)


# -- regex engine (literal NFA -> DFA over the byte alphabet) ----------------
#
# A deliberately small, dependency-free engine: literals, escapes
# (\d \w \s \. \\ ...), ``.``, character classes ``[a-z0-9_]`` /
# ``[^...]``, grouping ``(...)``, alternation ``|`` and the
# quantifiers ``* + ? {m} {m,} {m,n}``. Anchored both ends (the whole
# OUTPUT must match — that is what constrained generation means).
# Thompson construction then subset construction; the alphabet is the
# first 256 code points (the byte vocabulary the test models speak).

_ALPHABET_MAX = 256

_ESCAPE_CLASSES = {
    "d": frozenset("0123456789"),
    "w": frozenset(
        "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
    "s": frozenset(" \t\n\r\f\v"),
}


def _escape_set(ch: str) -> frozenset:
    if ch in _ESCAPE_CLASSES:
        return _ESCAPE_CLASSES[ch]
    if ch.upper() in _ESCAPE_CLASSES and ch.isupper():
        inv = _ESCAPE_CLASSES[ch.lower()]
        return frozenset(chr(c) for c in range(_ALPHABET_MAX)
                         if chr(c) not in inv)
    lit = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
           "0": "\0"}.get(ch, ch)
    return frozenset(lit)


class _RegexParser:
    """Recursive-descent parser to an AST of tuples:
    ("lit", frozenset) | ("cat", [..]) | ("alt", [..]) |
    ("star", node) | ("plus", node) | ("opt", node) | ("eps",)."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise ValueError(
                f"regex parse error at offset {self.i} in {self.p!r}")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self.i += 1
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        parts = []
        while True:
            ch = self._peek()
            if ch is None or ch in "|)":
                break
            parts.append(self._repeat())
        if not parts:
            return ("eps",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _repeat(self):
        node = self._atom()
        while True:
            ch = self._peek()
            if ch == "*":
                self.i += 1
                node = ("star", node)
            elif ch == "+":
                self.i += 1
                node = ("plus", node)
            elif ch == "?":
                self.i += 1
                node = ("opt", node)
            elif ch == "{":
                node = self._bounded(node)
            else:
                return node

    def _bounded(self, node):
        j = self.p.index("}", self.i)
        body = self.p[self.i + 1:j]
        self.i = j + 1
        if "," in body:
            lo_s, hi_s = body.split(",", 1)
            lo = int(lo_s) if lo_s else 0
            hi = int(hi_s) if hi_s else None
        else:
            lo = hi = int(body)
        parts: List[Any] = [node] * lo
        if hi is None:
            parts.append(("star", node))
        else:
            if hi < lo:
                raise ValueError(f"bad repeat bound {{{body}}}")
            parts.extend(("opt", node) for _ in range(hi - lo))
        if not parts:
            return ("eps",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _atom(self):
        ch = self._peek()
        if ch == "(":
            self.i += 1
            node = self._alt()
            if self._peek() != ")":
                raise ValueError(f"unbalanced '(' in {self.p!r}")
            self.i += 1
            return node
        if ch == "[":
            return ("lit", self._char_class())
        if ch == ".":
            self.i += 1
            return ("lit", frozenset(
                chr(c) for c in range(_ALPHABET_MAX) if chr(c) != "\n"))
        if ch == "\\":
            self.i += 2
            return ("lit", _escape_set(self.p[self.i - 1]))
        if ch is None or ch in "*+?{":
            raise ValueError(
                f"regex parse error at offset {self.i} in {self.p!r}")
        self.i += 1
        return ("lit", frozenset(ch))

    def _char_class(self) -> frozenset:
        assert self.p[self.i] == "["
        self.i += 1
        negate = self._peek() == "^"
        if negate:
            self.i += 1
        chars: set = set()
        first = True
        while True:
            ch = self._peek()
            if ch is None:
                raise ValueError(f"unbalanced '[' in {self.p!r}")
            if ch == "]" and not first:
                self.i += 1
                break
            first = False
            if ch == "\\":
                self.i += 2
                chars |= _escape_set(self.p[self.i - 1])
                continue
            self.i += 1
            if self._peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                hi = self.p[self.i + 1]
                self.i += 2
                if hi == "\\":
                    hi = self.p[self.i]
                    self.i += 1
                for c in range(ord(ch), ord(hi) + 1):
                    chars.add(chr(c))
            else:
                chars.add(ch)
        if negate:
            return frozenset(chr(c) for c in range(_ALPHABET_MAX)
                             if chr(c) not in chars)
        return frozenset(chars)

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None


class _Nfa:
    """Thompson NFA: states are ints, transitions char->set, eps set."""

    def __init__(self):
        self.trans: List[Dict[str, set]] = []
        self.eps: List[set] = []

    def state(self) -> int:
        self.trans.append({})
        self.eps.append(set())
        return len(self.trans) - 1

    def build(self, node, src: int, dst: int) -> None:
        kind = node[0]
        if kind == "eps":
            self.eps[src].add(dst)
        elif kind == "lit":
            for ch in node[1]:
                self.trans[src].setdefault(ch, set()).add(dst)
        elif kind == "cat":
            cur = src
            for part in node[1][:-1]:
                nxt = self.state()
                self.build(part, cur, nxt)
                cur = nxt
            self.build(node[1][-1], cur, dst)
        elif kind == "alt":
            for part in node[1]:
                a, b = self.state(), self.state()
                self.eps[src].add(a)
                self.build(part, a, b)
                self.eps[b].add(dst)
        elif kind == "star":
            a, b = self.state(), self.state()
            self.eps[src].update((a, dst))
            self.build(node[1], a, b)
            self.eps[b].update((a, dst))
        elif kind == "plus":
            a, b = self.state(), self.state()
            self.eps[src].add(a)
            self.build(node[1], a, b)
            self.eps[b].update((a, dst))
        elif kind == "opt":
            a, b = self.state(), self.state()
            self.eps[src].update((a, dst))
            self.build(node[1], a, b)
            self.eps[b].add(dst)
        else:  # pragma: no cover - parser emits only the kinds above
            raise ValueError(f"unknown regex node {kind!r}")

    def closure(self, states: Iterable[int]) -> frozenset:
        stack = list(states)
        seen = set(stack)
        while stack:
            s = stack.pop()
            for n in self.eps[s]:
                if n not in seen:
                    seen.add(n)
                    stack.append(n)
        return frozenset(seen)


class _CharDfa:
    """Character-level DFA via lazy subset construction."""

    def __init__(self, pattern: str):
        ast = _RegexParser(pattern).parse()
        self._nfa = _Nfa()
        start, accept = self._nfa.state(), self._nfa.state()
        self._nfa.build(ast, start, accept)
        self._accept_nfa = accept
        self._sets: List[frozenset] = [self._nfa.closure([start])]
        self._ids: Dict[frozenset, int] = {self._sets[0]: 0}
        self._trans: List[Dict[str, int]] = [{}]
        self.start = 0

    def step(self, state: int, ch: str) -> int:
        """-1 = dead."""
        cached = self._trans[state].get(ch)
        if cached is not None:
            return cached
        nxt: set = set()
        for s in self._sets[state]:
            nxt.update(self._nfa.trans[s].get(ch, ()))
        if not nxt:
            self._trans[state][ch] = -1
            return -1
        closed = self._nfa.closure(nxt)
        sid = self._ids.get(closed)
        if sid is None:
            sid = len(self._sets)
            self._sets.append(closed)
            self._ids[closed] = sid
            self._trans.append({})
        self._trans[state][ch] = sid
        return sid

    def accepting(self, state: int) -> bool:
        return self._accept_nfa in self._sets[state]


class _VocabTrie:
    """Prefix trie over the token vocabulary: tokens sharing a prefix
    share the DFA walk when a state's token transitions are computed.
    Nodes: (children: {char: node}, tokens_ending_here: [ids])."""

    def __init__(self, vocab: Sequence[str]):
        self.root: Tuple[Dict[str, Any], List[int]] = ({}, [])
        for tid, text in enumerate(vocab):
            if not text:
                continue    # empty-string tokens can never be stepped
            node = self.root
            for ch in text:
                node = node[0].setdefault(ch, ({}, []))
            node[1].append(tid)


# -- compiled grammar + per-request cursor -----------------------------------

class CompiledGrammar:
    """Token-level automaton over a character DFA: per automaton state,
    the set of legal tokens (as a packed row) and the token→state
    transition map, both computed lazily and memoized. Shared by every
    request using the same (grammar, vocab, eos) triple."""

    def __init__(self, dfa: _CharDfa, vocab: Sequence[str],
                 vocab_size: int, eos_id: Optional[int]):
        self._dfa = dfa
        self._trie = _VocabTrie(vocab)
        self.vocab_size = int(vocab_size)
        self.eos_id = int(eos_id) if eos_id is not None else None
        self._rows: Dict[int, np.ndarray] = {}
        self._steps: Dict[int, Dict[int, int]] = {}
        self.start = dfa.start

    def _expand(self, state: int) -> None:
        allowed: List[int] = []
        steps: Dict[int, int] = {}
        stack = [(self._trie.root, state)]
        while stack:
            (children, ending), dstate = stack.pop()
            for tid in ending:
                allowed.append(tid)
                steps[tid] = dstate
            for ch, child in children.items():
                nxt = self._dfa.step(dstate, ch)
                if nxt >= 0:
                    stack.append((child, nxt))
        row = pack_token_ids(allowed, self.vocab_size)
        if self.eos_id is not None and self._dfa.accepting(state):
            row = row.copy()
            lane = row.view(np.uint32)
            lane[self.eos_id >> 5] |= \
                np.uint32(1) << np.uint32(self.eos_id & 31)
        row.setflags(write=False)
        self._rows[state] = row
        self._steps[state] = steps

    def mask(self, state: int) -> np.ndarray:
        if state not in self._rows:
            self._expand(state)
        return self._rows[state]

    def step(self, state: int, token: int) -> int:
        """Next automaton state, or -1 if ``token`` is illegal here
        (EOS is never steppable — it terminates, it does not extend)."""
        if state not in self._steps:
            self._expand(state)
        return self._steps[state].get(int(token), -1)

    def accepting(self, state: int) -> bool:
        return self._dfa.accepting(state)

    def is_dead(self, state: int) -> bool:
        """No legal extension token AND not accepting: the request can
        neither continue nor stop legally."""
        if state not in self._steps:
            self._expand(state)
        return not self._steps[state] and not self._dfa.accepting(state)


class _SetGrammar(CompiledGrammar):
    """AllowedTokens lowered to the same interface: one state, a fixed
    row, every allowed token loops back (EOS always legal — a token
    allow-list constrains WHICH tokens, not WHEN to stop)."""

    def __init__(self, tokens: Iterable[int], vocab_size: int,
                 eos_id: Optional[int]):
        self.vocab_size = int(vocab_size)
        self.eos_id = int(eos_id) if eos_id is not None else None
        toks = sorted({int(t) for t in tokens
                       if 0 <= int(t) < self.vocab_size})
        if self.eos_id is not None:
            row_ids = set(toks) | {self.eos_id}
        else:
            row_ids = set(toks)
        self._row = pack_token_ids(row_ids, self.vocab_size)
        self._row.setflags(write=False)
        self._tokens = frozenset(toks)
        self.start = 0

    def mask(self, state: int) -> np.ndarray:
        return self._row

    def step(self, state: int, token: int) -> int:
        return 0 if int(token) in self._tokens else -1

    def accepting(self, state: int) -> bool:
        return True

    def is_dead(self, state: int) -> bool:
        return not self._tokens


class ConstraintState:
    """Per-request cursor over a :class:`CompiledGrammar` — the object
    the serving engine owns per constrained slot. The authoritative
    state only moves through :meth:`advance` (called at token COMMIT),
    which is why speculative rollback is free: rejected draft tokens
    were stepped on throwaway ints, never on this cursor."""

    __slots__ = ("grammar", "state", "done")

    def __init__(self, grammar: CompiledGrammar):
        self.grammar = grammar
        self.state = grammar.start
        self.done = False

    def mask_row(self) -> np.ndarray:
        """Packed row for the CURRENT state (next-token legality)."""
        return self.grammar.mask(self.state)

    def accepting(self) -> bool:
        return self.grammar.accepting(self.state)

    def dead(self) -> bool:
        return self.grammar.is_dead(self.state)

    def advance(self, token: int) -> Optional[np.ndarray]:
        """Commit ``token``: step the automaton and return the NEXT
        mask row — or ``None`` when the grammar dead-ends (illegal
        token, or a successor state with no legal continuation and no
        accept). EOS does not step: it marks the cursor done and
        returns the identity row (the slot is retiring anyway)."""
        token = int(token)
        if self.done:
            return identity_row(self.grammar.vocab_size)
        if self.grammar.eos_id is not None and \
                token == self.grammar.eos_id:
            if not self.grammar.accepting(self.state):
                return None
            self.done = True
            return identity_row(self.grammar.vocab_size)
        nxt = self.grammar.step(self.state, token)
        if nxt < 0:
            return None
        self.state = nxt
        if self.grammar.is_dead(nxt):
            return None
        return self.grammar.mask(nxt)

    def draft_masks(self, draft: Sequence[int], k: int) -> np.ndarray:
        """Per-position verify masks for a k-token draft: a
        NON-MUTATING walk (speculative rollback stays free — the
        authoritative cursor only moves through :meth:`advance`).
        Row ``j`` masks verify position ``j`` — the legality of the
        state after drafts ``0..j-1``. The walk stops at the first
        draft token the grammar rejects (or that reaches EOS/a dead
        successor): that position's masked distribution gives the
        draft probability 0, so the verifier's acceptance prefix ends
        there and every later position's row is never committed —
        identity rows keep their (discarded) draws finite."""
        g = self.grammar
        width = mask_width(g.vocab_size)
        rows = np.full((int(k) + 1, width), -1, np.int32)
        if self.done:
            return rows
        s = self.state
        rows[0] = g.mask(s)
        for j in range(int(k)):
            t = int(draft[j])
            if g.eos_id is not None and t == g.eos_id:
                break   # EOS drafted: legal iff row j allowed it;
                        # either way nothing past it can commit
            nxt = g.step(s, t)
            if nxt < 0 or g.is_dead(nxt):
                break
            s = nxt
            rows[j + 1] = g.mask(s)
        return rows


# -- user-facing constraint descriptions -------------------------------------

def _default_vocab(vocab_size: int) -> List[str]:
    """Byte vocabulary: token i <-> chr(i) (the test models' alphabet).
    Ids past 256 (real-tokenizer sizes) map to empty strings — never
    legal under a character grammar, exactly right for ids a byte
    grammar cannot spell."""
    return [chr(i) if i < _ALPHABET_MAX else ""
            for i in range(int(vocab_size))]


class GrammarConstraint:
    """Base contract: ``compile(vocab_size, eos_id, vocab=None)``
    returns a (cached) :class:`CompiledGrammar`. Instances are cheap
    value objects safe to share across requests and engines."""

    def compile(self, vocab_size: int, eos_id: Optional[int],
                vocab: Optional[Sequence[str]] = None) -> CompiledGrammar:
        raise NotImplementedError

    def state(self, vocab_size: int, eos_id: Optional[int],
              vocab: Optional[Sequence[str]] = None) -> ConstraintState:
        return ConstraintState(self.compile(vocab_size, eos_id, vocab))


class AllowedTokens(GrammarConstraint):
    """The trivial constraint: a fixed allow-list of token ids
    (classification / multiple-choice heads). EOS is always legal."""

    def __init__(self, tokens: Iterable[int]):
        self.tokens = tuple(int(t) for t in tokens)
        self._cache: Dict[tuple, CompiledGrammar] = {}

    def compile(self, vocab_size, eos_id, vocab=None):
        key = (int(vocab_size), eos_id)
        hit = self._cache.get(key)
        if hit is None:
            hit = _SetGrammar(self.tokens, vocab_size, eos_id)
            self._cache[key] = hit
        return hit

    def __repr__(self):
        return f"AllowedTokens({len(self.tokens)} tokens)"


class RegexConstraint(GrammarConstraint):
    """Output must match ``pattern`` end to end. ``vocab`` maps token
    id → surface string (default: the byte vocabulary)."""

    def __init__(self, pattern: str,
                 vocab: Optional[Sequence[str]] = None):
        _RegexParser(pattern).parse()   # fail fast on a bad pattern
        self.pattern = pattern
        self.vocab = list(vocab) if vocab is not None else None
        self._cache: Dict[tuple, CompiledGrammar] = {}

    def compile(self, vocab_size, eos_id, vocab=None):
        key = (int(vocab_size), eos_id)
        hit = self._cache.get(key)
        if hit is None:
            voc = self.vocab if self.vocab is not None else \
                (list(vocab) if vocab is not None
                 else _default_vocab(vocab_size))
            if len(voc) < int(vocab_size):
                voc = list(voc) + [""] * (int(vocab_size) - len(voc))
            hit = CompiledGrammar(_CharDfa(self.pattern), voc,
                                  vocab_size, eos_id)
            self._cache[key] = hit
        return hit

    def __repr__(self):
        return f"RegexConstraint({self.pattern!r})"


# JSON schema -> regex lowering. JSON is not regular, so nesting is
# DEPTH-BOUNDED (the standard FSM-guided-decoding move): a generic
# object/array expands ``max_depth`` levels before bottoming out at
# scalars. Canonical form — no insignificant whitespace, object
# properties in declared order, listed properties required.

_JSON_STRING = r'"([^"\\]|\\.)*"'
_JSON_INT = r"-?(0|[1-9][0-9]*)"
_JSON_NUMBER = _JSON_INT + r"(\.[0-9]+)?([eE][+-]?[0-9]+)?"


def _regex_escape(text: str) -> str:
    out = []
    for ch in text:
        out.append("\\" + ch if ch in r"\.[]{}()*+?|^$/" else ch)
    return "".join(out)


def _schema_regex(schema: Any, depth: int) -> str:
    if schema is True or schema is None or schema == {}:
        return _json_value_regex(depth)
    if not isinstance(schema, dict):
        raise ValueError(f"unsupported JSON schema node: {schema!r}")
    if "enum" in schema:
        import json as _json
        alts = "|".join(
            _regex_escape(_json.dumps(v, separators=(",", ":")))
            for v in schema["enum"])
        return f"({alts})"
    if "const" in schema:
        import json as _json
        return _regex_escape(
            _json.dumps(schema["const"], separators=(",", ":")))
    typ = schema.get("type")
    if isinstance(typ, list):
        return "(" + "|".join(
            _schema_regex(dict(schema, type=t), depth) for t in typ) + ")"
    if typ == "string":
        return _JSON_STRING
    if typ == "integer":
        return _JSON_INT
    if typ == "number":
        return _JSON_NUMBER
    if typ == "boolean":
        return "(true|false)"
    if typ == "null":
        return "null"
    if typ == "array":
        item = _schema_regex(schema.get("items", True),
                             max(depth - 1, 0))
        return rf"(\[\]|\[{item}(,{item})*\])"
    if typ == "object":
        props = schema.get("properties")
        if props:
            parts = []
            for name, sub in props.items():
                key = _regex_escape(
                    '"' + name.replace("\\", "\\\\")
                    .replace('"', '\\"') + '"')
                parts.append(key + ":"
                             + _schema_regex(sub, max(depth - 1, 0)))
            return r"\{" + ",".join(parts) + r"\}"
        member = _JSON_STRING + ":" + _json_value_regex(
            max(depth - 1, 0))
        return rf"(\{{\}}|\{{{member}(,{member})*\}})"
    raise ValueError(f"unsupported JSON schema: {schema!r}")


def _json_value_regex(depth: int) -> str:
    scalar = (f"({_JSON_STRING}|{_JSON_NUMBER}|true|false|null)")
    if depth <= 0:
        return scalar
    inner = _json_value_regex(depth - 1)
    arr = rf"\[\]|\[{inner}(,{inner})*\]"
    member = _JSON_STRING + ":" + inner
    obj = rf"\{{\}}|\{{{member}(,{member})*\}}"
    return f"({scalar}|{arr}|{obj})"


class JsonSchemaConstraint(RegexConstraint):
    """Output must be canonical JSON matching ``schema`` (a practical
    subset: type string/integer/number/boolean/null, enum/const,
    arrays, objects with declared properties; generic values nest to
    ``max_depth``). Lowered to a regex, then to the shared token DFA
    machinery."""

    def __init__(self, schema: Any = None, max_depth: int = 2,
                 vocab: Optional[Sequence[str]] = None):
        self.schema = schema
        self.max_depth = int(max_depth)
        pattern = _schema_regex(schema, self.max_depth) \
            if schema not in (None, True, {}) \
            else _json_value_regex(self.max_depth)
        super().__init__(pattern, vocab=vocab)

    def __repr__(self):
        return f"JsonSchemaConstraint({self.schema!r})"


def from_response_format(spec: Any) -> Optional[GrammarConstraint]:
    """Lower a wire-level ``response_format`` (the front door / ingest
    surface) to a constraint. Accepts a GrammarConstraint verbatim,
    ``None`` (unconstrained) or a dict::

        {"type": "regex", "pattern": "..."}
        {"type": "json_object"}                       # any JSON value
        {"type": "json_schema", "schema": {...}}
        {"type": "allowed_tokens", "tokens": [...]}
    """
    if spec is None:
        return None
    if isinstance(spec, GrammarConstraint):
        return spec
    if not isinstance(spec, dict) or "type" not in spec:
        raise ValueError(
            f"response_format must be a GrammarConstraint or a dict "
            f"with a 'type' key, got {spec!r}")
    kind = spec["type"]
    if kind == "regex":
        return RegexConstraint(spec["pattern"])
    if kind == "json_object":
        return JsonSchemaConstraint(None,
                                    max_depth=int(spec.get("max_depth", 2)))
    if kind == "json_schema":
        return JsonSchemaConstraint(
            spec.get("schema"), max_depth=int(spec.get("max_depth", 2)))
    if kind == "allowed_tokens":
        return AllowedTokens(spec["tokens"])
    raise ValueError(f"unknown response_format type {kind!r}")
