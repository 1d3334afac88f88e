"""Regex -> DFA compiler for in-circuit matching.

Stands in for the external zk-regex-circom toolchain
(email-verifier.circom:5 imports BodyHashRegex from @zk-email/zk-regex-circom
2.3.2): compiles a restricted regex dialect to a byte-alphabet DFA whose
transition relation the gadget in gadgets/regex_dfa.py arithmetizes, with
capture-group "reveal" marking (the match-flag + reveal-array contract of
zk-regex, SURVEY §7 hard part (e)).

Supported dialect (what the DKIM/email circuits need):
  literals, escapes (\\r \\n \\\\ etc.), character classes [a-z0-9+/=] and
  negations [^;], '.', alternation |, groups (...) with optional reveal
  marking via capture index, quantifiers * + ?.
"""

from __future__ import annotations

from dataclasses import dataclass, field


EPS = -1


@dataclass
class _NfaState:
    edges: list = field(default_factory=list)  # (byteset frozenset | EPS, target)
    reveal: int = -1  # capture group id active on OUTGOING consuming edges


class _Parser:
    """Recursive-descent regex parser building an NFA (Thompson)."""

    def __init__(self, pattern: str, reveal_groups: set[int] | None = None):
        self.pat = pattern
        self.pos = 0
        self.states: list[_NfaState] = []
        self.group_counter = 0
        self.reveal_groups = reveal_groups or set()

    def new_state(self) -> int:
        self.states.append(_NfaState())
        return len(self.states) - 1

    def parse(self):
        start, end = self._alt(reveal=-1)
        return start, end, self.states

    def _peek(self):
        return self.pat[self.pos] if self.pos < len(self.pat) else None

    def _eat(self):
        c = self.pat[self.pos]
        self.pos += 1
        return c

    def _alt(self, reveal: int):
        starts, ends = [], []
        s, e = self._concat(reveal)
        starts.append(s)
        ends.append(e)
        while self._peek() == "|":
            self._eat()
            s, e = self._concat(reveal)
            starts.append(s)
            ends.append(e)
        if len(starts) == 1:
            return starts[0], ends[0]
        st, en = self.new_state(), self.new_state()
        for s, e in zip(starts, ends):
            self.states[st].edges.append((EPS, s))
            self.states[e].edges.append((EPS, en))
        return st, en

    def _concat(self, reveal: int):
        start = self.new_state()
        cur = start
        while self._peek() is not None and self._peek() not in "|)":
            s, e = self._quant(reveal)
            self.states[cur].edges.append((EPS, s))
            cur = e
        return start, cur

    def _quant(self, reveal: int):
        s, e = self._atom(reveal)
        c = self._peek()
        if c == "*":
            self._eat()
            st, en = self.new_state(), self.new_state()
            self.states[st].edges.append((EPS, s))
            self.states[st].edges.append((EPS, en))
            self.states[e].edges.append((EPS, s))
            self.states[e].edges.append((EPS, en))
            return st, en
        if c == "+":
            self._eat()
            en = self.new_state()
            self.states[e].edges.append((EPS, s))
            self.states[e].edges.append((EPS, en))
            return s, en
        if c == "?":
            self._eat()
            st, en = self.new_state(), self.new_state()
            self.states[st].edges.append((EPS, s))
            self.states[st].edges.append((EPS, en))
            self.states[e].edges.append((EPS, en))
            return st, en
        return s, e

    def _atom(self, reveal: int):
        c = self._peek()
        if c == "(":
            self._eat()
            gid = self.group_counter
            self.group_counter += 1
            inner_reveal = gid if gid in self.reveal_groups else reveal
            s, e = self._alt(inner_reveal)
            assert self._eat() == ")", "unbalanced group"
            return s, e
        if c == "[":
            byteset = self._char_class()
            return self._edge(byteset, reveal)
        if c == ".":
            self._eat()
            return self._edge(frozenset(range(256)) - {ord("\n")}, reveal)
        if c == "\\":
            self._eat()
            byteset = frozenset({self._escape(self._eat())})
            return self._edge(byteset, reveal)
        self._eat()
        return self._edge(frozenset({ord(c)}), reveal)

    def _edge(self, byteset, reveal: int):
        s, e = self.new_state(), self.new_state()
        self.states[s].edges.append((byteset, e))
        self.states[s].reveal = reveal
        return s, e

    def _escape(self, c: str) -> int:
        return {"n": 10, "r": 13, "t": 9, "0": 0}.get(c, ord(c))

    def _char_class(self):
        assert self._eat() == "["
        negate = False
        if self._peek() == "^":
            negate = True
            self._eat()
        items = set()
        while self._peek() != "]":
            c = self._eat()
            if c == "\\":
                c0 = self._escape(self._eat())
            else:
                c0 = ord(c)
            if self._peek() == "-" and self.pat[self.pos + 1] != "]":
                self._eat()
                c2 = self._eat()
                c1 = self._escape(self._eat()) if c2 == "\\" else ord(c2)
                items.update(range(c0, c1 + 1))
            else:
                items.add(c0)
        self._eat()
        return frozenset(range(256)) - frozenset(items) if negate else frozenset(items)


@dataclass
class DFA:
    """Deterministic automaton over bytes with per-(state,byte) reveal tags.

    transitions: int array semantics via dict {(state, byte): next_state};
    missing entries go to the dead state (-1 semantics -> state `dead`).
    """

    n_states: int
    start: int
    accepting: frozenset
    dead: int
    # dense tables filled by compile():
    next_state: list  # [state][byte] -> state
    reveal_tag: list  # [state][byte] -> group id or -1 (tag of the consumed byte)


def compile_regex(
    pattern: str, reveal_groups: set[int] | None = None, anchored: bool = True
) -> DFA:
    """regex -> DFA via subset construction, preserving reveal tags.

    anchored=False prepends an implicit any-byte self-loop (match anywhere),
    like zk-regex's scanning semantics."""
    parser = _Parser(pattern, reveal_groups)
    start, end, states = parser.parse()
    if not anchored:
        s0 = parser.new_state()
        states = parser.states
        states[s0].edges.append((frozenset(range(256)), s0))
        states[s0].edges.append((EPS, start))
        start = s0

    def eps_closure(ss: frozenset) -> frozenset:
        stack, seen = list(ss), set(ss)
        while stack:
            s = stack.pop()
            for sym, t in states[s].edges:
                if sym == EPS and t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = eps_closure(frozenset({start}))
    dfa_states = {start_set: 0}
    order = [start_set]
    next_state: list = []
    reveal_tag: list = []
    i = 0
    while i < len(order):
        cur = order[i]
        row = [None] * 256
        tags = [-1] * 256
        for b in range(256):
            targets = set()
            tag = -1
            for s in cur:
                for sym, t in states[s].edges:
                    if sym != EPS and b in sym:
                        targets.add(t)
                        if states[s].reveal != -1:
                            tag = states[s].reveal
            if targets:
                clo = eps_closure(frozenset(targets))
                if clo not in dfa_states:
                    dfa_states[clo] = len(order)
                    order.append(clo)
                row[b] = dfa_states[clo]
                tags[b] = tag
            else:
                row[b] = -1
        next_state.append(row)
        reveal_tag.append(tags)
        i += 1

    # dead state: all bytes -> dead
    dead = len(order)
    for row in next_state:
        for b in range(256):
            if row[b] == -1:
                row[b] = dead
    next_state.append([dead] * 256)
    reveal_tag.append([-1] * 256)

    accepting = frozenset(
        idx for ss, idx in dfa_states.items() if end in ss
    )
    return DFA(
        n_states=len(order) + 1,
        start=0,
        accepting=accepting,
        dead=dead,
        next_state=next_state,
        reveal_tag=reveal_tag,
    )


def dfa_match(dfa: DFA, data: bytes, anchored: bool = False):
    """Host-side matcher mirroring the circuit semantics: scan the whole
    buffer, match succeeds if an accepting state is reached; returns
    (matched, reveal_bytes_per_group) for the FIRST match."""
    best = None
    starts = range(1) if anchored else range(len(data) + 1)
    for st_pos in starts:
        state = dfa.start
        reveals: dict[int, bytearray] = {}
        for i in range(st_pos, len(data)):
            b = data[i]
            tag = dfa.reveal_tag[state][b]
            state = dfa.next_state[state][b]
            if state == dfa.dead:
                break
            if tag != -1:
                reveals.setdefault(tag, bytearray()).extend([b])
            if state in dfa.accepting:
                return True, {k: bytes(v) for k, v in reveals.items()}
        if anchored:
            break
    return False, {}


def dfa_state_after(dfa: DFA, prefix: bytes) -> int:
    """State reached after consuming `prefix` from the start state.

    Used to realize zk-regex's `(\\r\\n|^)` anchor: compile the pattern with
    a literal \\r\\n prefix (unanchored), then start the in-circuit scan in
    the post-\\r\\n state — position 0 then behaves as if at a line start.
    """
    s = dfa.start
    for b in prefix:
        s = dfa.next_state[s][b]
    return s


# The DKIM body-hash regex used by the reference's BodyHashRegex
# (zk-regex-circom 2.3.2): matches "bh=<base64>;" inside the canonicalized
# DKIM-Signature header, revealing the base64 value (group 0).
BODY_HASH_PATTERN = r"bh=([a-zA-Z0-9+/=]+);"

# Full anchored pattern of zk-regex-circom 2.3.2's body_hash.json
# (email-verifier.circom:124-131): the bh= tag must occur inside a
# DKIM-Signature header at a line start, after at least one `tag=value; `
# pair (v=1 is mandatory first per RFC 6376). Group 1 (the base64 value)
# is the reveal group. Compile with anchored=False and start the scan at
# dfa_state_after(dfa, b"\r\n") to get the (\r\n|^) semantics.
BODY_HASH_ANCHORED_PATTERN = (
    r"\r\ndkim-signature:([a-z]+=[^;]+; )+bh=([a-zA-Z0-9+/=]+);"
)
BODY_HASH_REVEAL_GROUP = 1
