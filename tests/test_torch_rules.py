"""The port's rule compiler and the `rule_masks` kernel's twin against the
JAX package.

`emqx_tpu_torch.rules.sql` / `.compile` (port) against `emqx_tpu.rules.sql`
/ `.compile` on the same SQL text and the same seeded messages:

- programs tuple-equal, lanes and `exact` flags equal;
- features and validity from `extract_features` equal, suspect flags too;
- `eval_rule_masks_plain` (and the CPU wrapper) bit-equal to the JAX
  trace's `eval_rule_masks`, on the `semantic_256k` rule set of
  `chip_smoke.py` (all 20 opcodes), on the random WHERE generator of
  `tests/test_rule_compile.py` and on one that adds divisions by
  fractions, large values and NaN;
- the corner cases: `b = 0.5` in `div` (NaN with valid set in JAX), `mod`
  and `div` of negative operands, nulls, literal-only rules (F = 0), an
  empty program, the stack-depth limit;
- the port's numpy `eval_prog` and `DeviceRuleFilter.host_masks` against
  the JAX package's (both numpy).

The port runs on the CPU. The `cuda`-marked test at the end holds the
kernel against its twin on a card. Tolerance: EXACT equality (booleans).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from emqx_tpu.rules import compile as J_comp
from emqx_tpu.rules import sql as J_sql
from emqx_tpu_torch import kernels
from emqx_tpu_torch.rules import compile as P_comp
from emqx_tpu_torch.rules import sql as P_sql
from test_rule_compile import _gen_bool, _gen_ctx


def wheres_of(sql_wheres):
    return ([P_sql.parse_sql(f'SELECT * FROM "t/#" WHERE {w}').where for w in sql_wheres],
            [J_sql.parse_sql(f'SELECT * FROM "t/#" WHERE {w}').where for w in sql_wheres])


def compile_both(sql_wheres):
    """-> (port progs, JAX progs, port lanes, JAX lanes), each package
    compiling its own parse of the same text against a shared lane table."""
    p_ast, j_ast = wheres_of(sql_wheres)
    p_lanes, j_lanes = {}, {}
    p_progs, j_progs = [], []
    for pa, ja in zip(p_ast, j_ast):
        pr = P_comp.compile_where(pa, p_lanes)
        jr = J_comp.compile_where(ja, j_lanes)
        assert pr == jr  # (prog, exact) tuples, or both None
        assert pr is not None
        p_progs.append(pr[0])
        j_progs.append(jr[0])
    assert p_lanes == j_lanes
    return p_progs, j_progs, p_lanes, j_lanes


def masks_both(p_progs, j_progs, p_lanes, j_lanes, ctxs):
    """Features through both packages, then JAX's traced masks and the
    port's twin and CPU wrapper."""
    pf, pv, ps = P_comp.extract_features(ctxs, p_lanes)
    jf, jv, js = J_comp.extract_features(ctxs, j_lanes)
    np.testing.assert_array_equal(pf.view(np.uint32), jf.view(np.uint32))
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(ps, js)
    want = np.asarray(J_comp.eval_rule_masks(tuple(j_progs), jnp.asarray(jf), jnp.asarray(jv)))
    ft, vt = torch.from_numpy(pf), torch.from_numpy(pv)
    got = P_comp.eval_rule_masks_plain(p_progs, ft, vt)
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(P_comp.eval_rule_masks(p_progs, ft, vt).numpy(), want)
    return want, pf, pv


# -- programs ---------------------------------------------------------------


def test_rule_set_programs_equal_jax_and_cover_every_opcode():
    p_progs, j_progs, _pl, _jl = compile_both(chip_smoke.RULES_SQL)
    assert [tuple(p) for p in p_progs] == [tuple(j) for j in j_progs]
    used = {op[0] for p in p_progs for op in p}
    assert used == set(P_comp.OPCODES) and len(used) == 20


def test_fuzz_programs_equal_jax():
    rng = np.random.default_rng(0xC2)
    compile_both([_gen_bool(rng, 3) for _ in range(60)])


def test_encode_progs_layout():
    progs = [(("feat", 1), ("lit", 0.1), ("gt",)), (), (("blit", True),)]
    rc = P_comp.encode_progs(progs)
    assert rc.code.dtype == np.int32 and rc.offsets.dtype == np.int32
    assert rc.offsets.tolist() == [0, 3, 3, 4]
    op = P_comp.OPCODES
    assert rc.code.tolist() == [op["feat"], 1, op["lit"], 0, op["gt"], 0, op["blit"], 1]
    assert rc.lits.dtype == np.float32 and rc.lits[0] == np.float32(0.1)
    assert (rc.depth, rc.lanes) == (2, 2)


# -- masks ------------------------------------------------------------------


def test_rule_set_masks_equal_jax():
    rng = np.random.default_rng(70)
    p_progs, j_progs, pl, jl = compile_both(chip_smoke.RULES_SQL)
    topics = [f"device/{i}/mid/{j}/leaf" for i, j in
              zip(rng.integers(0, 60, 512), rng.integers(0, 1000, 512))]
    ctxs = chip_smoke.rule_messages(rng, topics)
    want, pf, pv = masks_both(p_progs, j_progs, pl, jl, ctxs)
    assert want.shape == (8, 512)
    # every rule passes some rows and fails others: the data decides
    assert want.any(axis=1).all() and (~want).any(axis=1).all()
    # the host twins (numpy) of both packages agree too
    p_filter = chip_smoke.rule_filter(chip_smoke.RULES_SQL, P_sql, P_comp)
    j_filter = chip_smoke.rule_filter(chip_smoke.RULES_SQL, J_sql, J_comp)
    assert p_filter.progs == j_filter.progs and p_filter.lanes == j_filter.lanes
    np.testing.assert_array_equal(p_filter.host_masks(ctxs), j_filter.host_masks(ctxs))
    # no idiv by a truncated zero here, so the numpy twin equals the device
    np.testing.assert_array_equal(p_filter.host_masks(ctxs), want)


def test_fuzz_masks_equal_jax():
    rng = np.random.default_rng(0xC1)
    for _ in range(25):
        p_progs, j_progs, pl, jl = compile_both([_gen_bool(rng, 3)])
        masks_both(p_progs, j_progs, pl, jl, [_gen_ctx(rng) for _ in range(16)])


def _gen_frac_ctx(rng):
    """Payload numbers that make the float paths differ: fractions (0.5
    truncates to 0), negatives, large values, NaN."""
    payload = {}
    for k in ("a", "b", "c"):
        r = rng.random()
        if r < 0.15:
            continue
        payload[k] = float(rng.choice([0.5, -0.5, 2.5, -3.5, 7.0, -7.0, 0.0, 1e30,
                                       -1e30, 3.4e38, 16777217.0, float("nan")]))
    return {"qos": int(rng.integers(0, 3)), "topic": "t/1",
            "payload": json.dumps(payload).encode()}


def _gen_frac_num(rng, depth):
    if depth <= 0 or rng.random() < 0.35:
        return str(rng.choice(["payload.a", "payload.b", "payload.c", "qos", "3", "0.5", "-2"]))
    op = rng.choice(["+", "-", "*", "/", "div", "mod"])
    return f"({_gen_frac_num(rng, depth - 1)} {op} {_gen_frac_num(rng, depth - 1)})"


def test_fuzz_fractional_divisions_equal_jax():
    rng = np.random.default_rng(0xC3)
    for _ in range(40):
        cmp = rng.choice(["=", "!=", ">", "<", ">=", "<="])
        where = f"{_gen_frac_num(rng, 2)} {cmp} {_gen_frac_num(rng, 2)}"
        if rng.random() < 0.3:
            # a bare operand in boolean position: its truthiness
            where = f"NOT ({where}) OR {rng.choice(['payload.a', 'payload.c', '-payload.b'])}"
        p_progs, j_progs, pl, jl = compile_both([where])
        masks_both(p_progs, j_progs, pl, jl, [_gen_frac_ctx(rng) for _ in range(32)])


def masks_of(sql_wheres, ctxs):
    p_progs, j_progs, pl, jl = compile_both(sql_wheres)
    return masks_both(p_progs, j_progs, pl, jl, ctxs)[0]


def ctx(**payload):
    return {"qos": 1, "topic": "t/1", "payload": json.dumps(payload).encode()}


def test_idiv_by_a_truncated_zero_is_nan_with_valid_set():
    rows = [ctx(a=7, b=0.5), ctx(a=7, b=2), ctx(a=0, b=0.5), ctx(a=7, b=0)]
    want = masks_of([
        "payload.a div payload.b > 1",      # NaN > 1: false
        # a valid NaN is unequal to itself; two invalids are equal
        "NOT (payload.a div payload.b = payload.a div payload.b)",
        "payload.a mod payload.b = payload.a mod payload.b",  # NaN = NaN: false
        "payload.a div payload.b = 3",
    ], rows)
    assert want[0].tolist() == [False, True, False, False]
    # b = 0 invalidates through the guard, and None = None
    assert want[1].tolist() == [True, False, True, False]
    assert want[2].tolist() == [False, True, False, True]
    assert want[3].tolist() == [False, True, False, False]


def test_div_and_mod_of_negative_operands():
    rows = [ctx(a=a, b=b) for a, b in
            ((-7, 3), (7, -3), (-7, -3), (-7.5, 2), (7.9, -2.2), (6, 3), (-6, 3))]
    want = masks_of([
        "payload.a div payload.b = -3", "payload.a div payload.b = -4",
        "payload.a mod payload.b = 2", "payload.a mod payload.b = -2",
        "payload.a mod payload.b = -1", "payload.a mod payload.b = 1",
        "payload.a mod payload.b = 0", "payload.a div payload.b = 2",
    ], rows)
    # -7 div 3 = -3 (floor), 7 div -3 = -3, -7.5 -> -7 div 2 = -4
    assert want[0].tolist() == [True, True, False, False, False, False, False]
    assert want[1].tolist() == [False, False, False, True, True, False, False]
    assert want[2].tolist() == [True, False, False, False, False, False, False]
    assert want[6].tolist() == [False, False, False, False, False, True, True]


def test_nulls_and_literal_only_rules():
    rows = [ctx(a=1), ctx(), {"qos": "x", "topic": "t/1", "payload": b"not json"}]
    want = masks_of([
        "payload.a = payload.zz", "payload.zz = payload.yy", "payload.zz != 3",
        "payload.a + payload.zz > 0", "NOT payload.zz < 1", "qos = 1",
    ], rows)
    assert want[0].tolist() == [False, True, True]
    assert want[1].tolist() == [True, True, True]
    assert want[4].tolist() == [True, True, True]
    assert want[5].tolist() == [True, True, False]
    # literal-only rules read no lane: F = 0
    p_progs, j_progs, pl, jl = compile_both(["1 = 1", "2 > 3", "true", "1", "-0.0 = 0",
                                             "1 / 0 = 1 / 0", "7 div 0.5 > 1"])
    assert pl == {} and jl == {}
    got = masks_both(p_progs, j_progs, pl, jl, rows)[0]
    assert got[0].tolist() == [True] * 3 and got[1].tolist() == [False] * 3
    assert got[4].tolist() == [True] * 3 and got[6].tolist() == [False] * 3


def test_empty_program_and_numeric_top():
    feats = torch.tensor([[0.0], [2.0], [float("nan")]])
    valid = torch.tensor([[True], [True], [False]])
    progs = [(), (("feat", 0),), (("feat", 0), ("neg",))]
    want = np.asarray(J_comp.eval_rule_masks(tuple(progs), jnp.asarray(feats.numpy()),
                                             jnp.asarray(valid.numpy())))
    got = P_comp.eval_rule_masks_plain(progs, feats, valid).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == [False] * 3 and got[1].tolist() == [False, True, False]
    assert P_comp.eval_rule_masks_plain([], feats, valid).shape == (0, 3)


def nested(n):
    """A WHERE clause whose program needs a stack of n entries."""
    return "payload.a" + " + (payload.a" * (n - 1) + ")" * (n - 1) + " > 0"


def test_depth_limit_raises_and_never_runs_elsewhere():
    ok_prog = compile_both([nested(P_comp.STACK_MAX)])[0]
    assert P_comp.encode_progs(ok_prog).depth == P_comp.STACK_MAX
    deep = compile_both([nested(P_comp.STACK_MAX + 3)])[0]
    with pytest.raises(ValueError, match="at most 64"):
        P_comp.encode_progs(deep)
    f = torch.zeros((2, 1))
    v = torch.ones((2, 1), dtype=torch.bool)
    for fn in (P_comp.eval_rule_masks, P_comp.eval_rule_masks_plain):
        with pytest.raises(ValueError, match="at most 64"):
            fn(deep, f, v)
    with pytest.raises(ValueError, match="malformed"):
        P_comp.encode_progs([(("feat", 0), ("and",))])
    with pytest.raises(ValueError, match="lane"):
        P_comp.eval_rule_masks([(("feat", 3), ("truthy",))], f, v)


def test_port_numpy_eval_prog_equals_jax_numpy_twin():
    rng = np.random.default_rng(0xC4)
    for _ in range(20):
        p_progs, j_progs, pl, jl = compile_both([_gen_bool(rng, 3)])
        ctxs = [_gen_frac_ctx(rng) for _ in range(16)] + [_gen_ctx(rng) for _ in range(16)]
        pf, pv, _ = P_comp.extract_features(ctxs, pl)
        np.testing.assert_array_equal(
            np.asarray(P_comp.eval_prog(p_progs[0], pf, pv, np)),
            np.asarray(J_comp.eval_prog(j_progs[0], pf, pv, np)))


# -- the program cache: encoded once a rule set and device ------------------


@pytest.fixture
def fresh_rule_code(monkeypatch):
    """An empty `rule_code` cache and zeroed counters; `encode_progs` calls
    counted apart from the cache's own count."""
    monkeypatch.setattr(P_comp, "_rule_code", type(P_comp._rule_code)())
    monkeypatch.setattr(P_comp, "RULE_CODE_COUNTS", {"uploads": 0})
    calls = []
    real = P_comp.encode_progs

    def counted(progs):
        calls.append(len(progs))
        return real(progs)

    monkeypatch.setattr(P_comp, "encode_progs", counted)
    return calls


def test_rule_code_key_is_the_programs_value_and_the_device():
    progs, _j, _pl, _jl = compile_both(list(chip_smoke.RULES_SQL))
    key = P_comp.rule_code_key(tuple(progs), "cpu")
    rebuilt = tuple(tuple(tuple(op) for op in p) for p in progs)
    assert rebuilt is not key[0]
    assert P_comp.rule_code_key(rebuilt, "cpu") == key
    assert P_comp.rule_code_key([list(map(list, p)) for p in progs], "cpu") == key
    assert P_comp.rule_code_key(tuple(progs), torch.device("cuda", 0)) != key
    assert P_comp.rule_code_key(tuple(progs[:-1]), "cpu") != key
    # literals that compare equal share an entry and encode alike
    a = P_comp.rule_code_key(((("lit", 1), ("truthy",)),), "cpu")
    b = P_comp.rule_code_key(((("lit", 1.0), ("truthy",)),), "cpu")
    assert a == b
    np.testing.assert_array_equal(P_comp.encode_progs(a[0]).lits,
                                  P_comp.encode_progs(b[0]).lits)


def test_rule_code_encodes_once_a_rule_set(fresh_rule_code):
    """Equal programs (a new tuple each call, as `DeviceRuleFilter.progs`
    makes, or a refresh over the same rules) reuse one buffer: no
    `encode_progs` and no new buffer; a refresh that changes the rule set
    encodes and places one more; the cache keeps the `RULE_CODE_CACHE_MAX`
    last used; the masks stay the twin's."""
    calls = fresh_rule_code
    rng = np.random.default_rng(72)
    filt = chip_smoke.rule_filter(chip_smoke.RULES_SQL, P_sql, P_comp)
    ctxs = chip_smoke.rule_messages(rng, ["device/1/a"] * 64)
    f, v = (torch.from_numpy(x) for x in filt.features(ctxs))
    first = P_comp.eval_rule_masks(filt.progs, f, v)
    _rc, buf = P_comp.rule_code(filt.progs, "cpu")
    again = chip_smoke.rule_filter(chip_smoke.RULES_SQL, P_sql, P_comp)  # the same rules
    for progs in (filt.progs, filt.progs, again.progs):
        assert torch.equal(P_comp.eval_rule_masks(progs, f, v), first)
        assert torch.equal(P_comp.eval_rule_masks_plain(progs, f, v), first)
    assert P_comp.rule_code(again.progs, "cpu")[1] is buf
    assert len(calls) == 1 and P_comp.RULE_CODE_COUNTS == {"uploads": 1}
    changed = chip_smoke.rule_filter(chip_smoke.RULES_SQL[:5], P_sql, P_comp)
    cf, cv = (torch.from_numpy(x) for x in changed.features(ctxs))
    got = P_comp.eval_rule_masks(changed.progs, cf, cv)
    np.testing.assert_array_equal(got.numpy(), changed.host_masks(ctxs))
    assert len(calls) == 2 and P_comp.RULE_CODE_COUNTS == {"uploads": 2}
    for k in range(P_comp.RULE_CODE_CACHE_MAX + 2):
        P_comp.rule_code(((("lit", float(k)), ("truthy",)),), "cpu")
        assert len(P_comp._rule_code) <= P_comp.RULE_CODE_CACHE_MAX
    assert len(calls) == 4 + P_comp.RULE_CODE_CACHE_MAX
    P_comp.eval_rule_masks(filt.progs, f, v)  # evicted by now: encoded again
    assert len(calls) == 5 + P_comp.RULE_CODE_CACHE_MAX
    # a program the kernel refuses is refused on every call and never kept
    deep = compile_both([nested(P_comp.STACK_MAX + 1)])[0]
    for _ in range(2):
        with pytest.raises(ValueError, match="at most 64"):
            P_comp.eval_rule_masks(deep, torch.zeros((2, 1)),
                                   torch.ones((2, 1), dtype=torch.bool))
    assert len(P_comp._rule_code) == P_comp.RULE_CODE_CACHE_MAX


# -- on the card: the kernel against its twin (skips without CUDA) ---------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_rule_masks_kernel_matches_twin_on_card(cuda_device):
    rng = np.random.default_rng(71)
    kernels.reset_launches()
    calls = 0
    cases = [list(chip_smoke.RULES_SQL), ["1 = 1", "7 div 0.5 > 1"]]
    cases += [[_gen_bool(rng, 3) for _ in range(6)] for _ in range(4)]
    for wheres in cases:
        p_progs, _j, pl, _jl = compile_both(wheres)
        for B in (1, 33, 4096):
            ctxs = ([_gen_frac_ctx(rng) for _ in range(B // 2)]
                    + chip_smoke.rule_messages(rng, ["device/42/x"] * (B - B // 2)))
            pf, pv, _ = P_comp.extract_features(ctxs, pl)
            ft = torch.from_numpy(pf).to(cuda_device)
            vt = torch.from_numpy(pv).to(cuda_device)
            got = P_comp.eval_rule_masks(p_progs, ft, vt)
            want = P_comp.eval_rule_masks_plain(p_progs, ft, vt)
            assert got.dtype == torch.bool and torch.equal(got, want)
            if wheres is cases[0]:  # no div by a feature: numpy agrees too
                np.testing.assert_array_equal(
                    got.cpu().numpy(),
                    np.stack([P_comp.eval_prog(p, pf, pv, np) for p in p_progs]))
            calls += 1
    assert kernels.LAUNCHES["rule_masks"] == calls


def rule_kernel_case(name):
    """-> (WHERE clauses, a context generator, whether the numpy host twin
    must agree: not where a `div` or `mod` meets a fraction, whose
    truncated zero numpy turns into inf where the device gives NaN)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "rule_set":
        return list(chip_smoke.RULES_SQL), lambda r, n: chip_smoke.rule_messages(
            r, [f"device/{i % 97}/x" for i in range(n)]), True
    if name == "one_rule":
        return ["payload.temp >= 20 AND payload.hum < 60"], lambda r, n: (
            chip_smoke.rule_messages(r, ["device/1/x"] * n)), True
    if name == "stack_max":  # a program at the kernel's STACK_MAX
        return [nested(P_comp.STACK_MAX), "payload.a > 1"], lambda r, n: [
            ctx(a=float(r.integers(-3, 4))) for _ in range(n)], True
    if name == "past_a_tile":  # more rules than a block's 8 warps
        return [_gen_bool(rng, 3) for _ in range(20)], lambda r, n: [
            _gen_ctx(r) for _ in range(n)], True
    if name == "fuzz":  # the programs of test_fuzz_masks_equal_jax
        frng = np.random.default_rng(0xC1)
        return [_gen_bool(frng, 3) for _ in range(25)], lambda r, n: [
            _gen_ctx(r) for _ in range(n)], True
    if name == "many_rules":  # programs past the 32 KB staged in shared memory
        return [_gen_bool(rng, 3) for _ in range(700)], lambda r, n: [
            _gen_ctx(r) for _ in range(n)], True
    assert name == "idiv_truncated_zero"
    return ["payload.a div payload.b > 1",
            "NOT (payload.a div payload.b = payload.a div payload.b)",
            "payload.a mod payload.b = payload.a mod payload.b",
            "payload.a div payload.b = 3"], lambda r, n: [
        [ctx(a=7, b=0.5), ctx(a=7, b=2), ctx(a=0, b=0.5), ctx(a=7, b=0)][i % 4]
        for i in range(n)], False


RULE_KERNEL_CASES = ["rule_set", "one_rule", "stack_max", "past_a_tile", "fuzz",
                     "many_rules", "idiv_truncated_zero"]


@pytest.mark.cuda
@pytest.mark.parametrize("F_min", [1, 10, 17, 500])
@pytest.mark.parametrize("name", RULE_KERNEL_CASES)
def test_rule_masks_kernel_cases_on_card(cuda_device, name, F_min):
    """The kernel against its twin (and the numpy host masks where they
    agree) on: the chip rule set, one rule, a program at STACK_MAX, more
    rules than a block's warps, the fuzz programs, a rule set whose
    programs pass the shared-memory copy (read through L1), the
    truncated-zero `idiv`; F widened with unread lanes to 1, 10, 17 and 500
    (past the staged features: read through L1); B 1, 33, 4,101 (a ragged
    last tile) and 8,192."""
    wheres, gen, numpy_ok = rule_kernel_case(name)
    p_progs, _j, pl, _jl = compile_both(wheres)
    rng = np.random.default_rng(F_min)
    kernels.reset_launches()
    for B in (1, 33, 4101, 8192):
        ctxs = gen(rng, B)
        pf, pv, _ = P_comp.extract_features(ctxs, pl)
        F = max(pf.shape[1], F_min)
        wf = rng.normal(size=(B, F)).astype(np.float32)
        wv = rng.random((B, F)) < 0.5
        wf[:, :pf.shape[1]], wv[:, :pf.shape[1]] = pf, pv
        ft = torch.from_numpy(wf).to(cuda_device)
        vt = torch.from_numpy(wv).to(cuda_device)
        got = P_comp.eval_rule_masks(p_progs, ft, vt)
        want = P_comp.eval_rule_masks_plain(p_progs, ft, vt)
        torch.cuda.synchronize()
        assert got.dtype == torch.bool and torch.equal(got, want), (name, F, B)
        if numpy_ok:
            np.testing.assert_array_equal(
                got.cpu().numpy(), np.stack([P_comp.eval_prog(p, wf, wv, np) for p in p_progs]))
    assert kernels.LAUNCHES["rule_masks"] == 4


@pytest.mark.cuda
def test_rule_code_uploads_once_a_rule_set_on_card(cuda_device, fresh_rule_code):
    """On the card: repeated calls with equal programs encode and upload
    nothing after the first; a changed rule set uploads once; the buffer
    lies on the card and the masks equal the twin's."""
    calls = fresh_rule_code
    rng = np.random.default_rng(73)
    filt = chip_smoke.rule_filter(chip_smoke.RULES_SQL, P_sql, P_comp)
    ctxs = chip_smoke.rule_messages(rng, ["device/1/a"] * 300)
    f, v = (torch.from_numpy(x).to(cuda_device) for x in filt.features(ctxs))
    for _ in range(4):
        got = P_comp.eval_rule_masks(filt.progs, f, v)
        assert torch.equal(got, P_comp.eval_rule_masks_plain(filt.progs, f, v))
    assert len(calls) == 1 and P_comp.RULE_CODE_COUNTS == {"uploads": 1}
    assert P_comp.rule_code(filt.progs, f.device)[1].is_cuda
    changed = chip_smoke.rule_filter(chip_smoke.RULES_SQL[::-1], P_sql, P_comp)
    cf, cv = (torch.from_numpy(x).to(cuda_device) for x in changed.features(ctxs))
    for _ in range(3):
        got = P_comp.eval_rule_masks(changed.progs, cf, cv)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), changed.host_masks(ctxs))
    assert len(calls) == 2 and P_comp.RULE_CODE_COUNTS == {"uploads": 2}
