"""The port's grammar compiler (``paddle_tpu_torch.inference.constrain``)
against the JAX package's: pure host numpy on both sides, held bit for
bit.

For each grammar and vocabulary the two packages compile, every packed
mask row a cursor meets equals the reference's, lane for lane: the start
row, the row after every token of seeded random walks (legal tokens
mostly, an illegal one now and then), the accepting and dead flags, and
the speculative ``draft_masks`` blocks. The packed-row helpers and the
wire-dict resolver are held the same way.
"""

import numpy as np
import pytest

from paddle_tpu.inference import constrain as jc

from paddle_tpu_torch.inference import constrain as pc

V = 256
GRAMMARS = {
    "digits": ("regex", r"[0-9]+"),
    "ab": ("regex", "ab"),
    "alt_bounded": ("regex", r"(foo|bar)[0-9]{2}"),
    "classes": ("regex", r"[a-c]*x?[^0-9]"),
    "json_object": ("wire", {"type": "json_object"}),
    "schema_int": ("schema", {"type": "integer"}),
    "schema_obj": ("schema", {"type": "object",
                              "properties": {"a": {"type": "integer"},
                                             "b": {"type": "boolean"}},
                              "required": ["a"]}),
    "schema_enum": ("schema", {"enum": ["red", "green", 3]}),
    "allowed": ("allowed", [5, 48, 49, 50, 97, 255]),
}


def _build(mod, kind, spec):
    if kind == "regex":
        return mod.RegexConstraint(spec)
    if kind == "schema":
        return mod.JsonSchemaConstraint(spec)
    if kind == "allowed":
        return mod.AllowedTokens(spec)
    return mod.from_response_format(spec)


def _walks(jg, pg, rng, n_walks=6, depth=12):
    """Seeded walks through both compiled grammars in lockstep, holding
    every row, flag and draft block equal."""
    for _ in range(n_walks):
        js, ps = jc.ConstraintState(jg), pc.ConstraintState(pg)
        np.testing.assert_array_equal(ps.mask_row(), js.mask_row())
        for _ in range(depth):
            row = js.mask_row()
            legal = [t for t in range(len(row) * 32)
                     if t < jg.vocab_size and jc.token_in_row(row, t)]
            # a draft of up to 4 tokens from this state, mostly legal
            draft = [int(rng.choice(legal)) if legal and rng.random() < 0.8
                     else int(rng.integers(0, V)) for _ in range(4)]
            np.testing.assert_array_equal(ps.draft_masks(draft, 4),
                                          js.draft_masks(draft, 4))
            if not legal:
                break
            tok = int(rng.choice(legal)) if rng.random() < 0.9 \
                else int(rng.integers(0, V))
            jr, pr = js.advance(tok), ps.advance(tok)
            assert (jr is None) == (pr is None), tok
            if jr is None:
                break
            np.testing.assert_array_equal(pr, jr)
            assert pr.dtype == np.int32
            assert ps.accepting() == js.accepting()
            assert ps.dead() == js.dead()


@pytest.mark.parametrize("eos", [None, 1])
@pytest.mark.parametrize("name", list(GRAMMARS))
def test_packed_rows_equal_the_reference_bit_for_bit(name, eos):
    kind, spec = GRAMMARS[name]
    jg = _build(jc, kind, spec).compile(V, eos)
    pg = _build(pc, kind, spec).compile(V, eos)
    assert type(pg).__name__ == type(jg).__name__
    np.testing.assert_array_equal(pg.mask(pg.start), jg.mask(jg.start))
    assert pg.is_dead(pg.start) == jg.is_dead(jg.start)
    _walks(jg, pg, np.random.default_rng(sum(map(ord, name))))


def test_default_byte_vocab_past_256_maps_to_empty_strings():
    """A vocabulary wider than the bytes (gpt2_small's 50257): ids at or
    above 256 map to "" in both packages, so no such token is ever
    legal under a character grammar, and the rows still match."""
    assert pc._default_vocab(300) == jc._default_vocab(300)
    assert pc._default_vocab(300)[256:] == [""] * 44
    Vw = 50257
    for spec in (r"[0-9]{3}", r"(ab|cd)+"):
        jg = jc.RegexConstraint(spec).compile(Vw, 50256)
        pg = pc.RegexConstraint(spec).compile(Vw, 50256)
        assert pg.mask(pg.start).shape == (pc.mask_width(Vw),) == (1571,)
        np.testing.assert_array_equal(pg.mask(pg.start), jg.mask(jg.start))
        s_j = jg.step(jg.start, ord(spec[1] if spec[0] == "(" else "7"))
        s_p = pg.step(pg.start, ord(spec[1] if spec[0] == "(" else "7"))
        np.testing.assert_array_equal(pg.mask(s_p), jg.mask(s_j))


def test_packed_row_helpers_equal():
    for Vx in (1, 31, 32, 33, 256, 50257):
        assert pc.mask_width(Vx) == jc.mask_width(Vx)
        np.testing.assert_array_equal(pc.identity_row(Vx),
                                      jc.identity_row(Vx))
    ids = [0, 31, 32, 255, 256, 300, -1]
    for Vx in (256, 300):
        pr, jr = pc.pack_token_ids(ids, Vx), jc.pack_token_ids(ids, Vx)
        np.testing.assert_array_equal(pr, jr)
        for t in range(Vx):
            assert pc.token_in_row(pr, t) == jc.token_in_row(jr, t)


@pytest.mark.parametrize("spec", [
    {"type": "regex", "pattern": "[0-9]{6}"},
    {"type": "json_schema", "schema": {"type": "boolean"}},
    {"type": "allowed_tokens", "tokens": [3, 4]},
    None,
    {"type": "nope"},
    {"type": "regex"},
    "not a dict",
    {"type": "allowed_tokens", "tokens": []},
])
def test_wire_dicts_resolve_or_fail_alike(spec):
    """``from_response_format`` resolves the same wire dicts to the same
    grammar class, and refuses the same malformed ones with the same
    exception type."""
    outcome = []
    for mod in (jc, pc):
        try:
            g = mod.from_response_format(spec)
            outcome.append(None if g is None else type(g).__name__)
        except Exception as e:      # the type is what is compared
            outcome.append(type(e).__name__)
    assert outcome[0] == outcome[1]
