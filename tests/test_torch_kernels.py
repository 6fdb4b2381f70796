"""The port's fuzzy-LUT kernels against the JAX reference, on the CPU.

On CPU tensors each wrapper runs its kernel's plain PyTorch version; these
tests hold it against the Pallas kernels (interpret mode, both ``lookup``
and ``mxu`` strategies) and the reference oracle on the same numpy inputs:
outputs within rtol = atol = 1e-5 (sum order only), leaves and int8 codes
exact. The CUDA kernels themselves are held against the plain versions on
the card (tests/test_torch_cuda.py and ``chip_smoke.py``).
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.fuzzy_lut.kernel import fuzzy_lut_pallas, fuzzy_lut_stack_pallas
from repro.kernels.fuzzy_lut.ops import prepare_feat_onehot
from repro.kernels.fuzzy_lut.quantized import (
    fuzzy_lut_q8_pallas, fuzzy_lut_stack_q8_pallas,
    quantize_lut_int8 as jax_quantize_lut_int8,
)
from repro.kernels.fuzzy_lut.ref import fuzzy_lut_matmul_ref, tree_descent_ref
from repro_torch.kernels.fuzzy_lut import _lib, kernel as K, quantized as Q

TOL = 1e-5
STRATEGIES = ["lookup", "mxu"]
# t, k, v, depth, n — the second is ragged in T, K and N
BANK_SHAPES = [(16, 4, 2, 3, 8), (37, 13, 4, 5, 70)]


def _bank_problem(seed, t, k, v, depth, n):
    rng = np.random.default_rng(seed)
    i = 2**depth - 1
    thr = rng.normal(size=(k, i)).astype(np.float32)
    thr[rng.random(size=thr.shape) < 0.1] = np.inf     # degenerate nodes
    return dict(x=rng.normal(size=(t, k, v)).astype(np.float32),
                features=rng.integers(0, v, size=(k, i)).astype(np.int32),
                thresholds=thr,
                lut=rng.normal(size=(k, i + 1, n)).astype(np.float32))


def _stack_problem(seed, t, ks, v, depth, nmax, n_out):
    """Padded stacks: groups k >= ks[l] hold +inf thresholds and zero rows."""
    rng = np.random.default_rng(seed)
    nl, kmax, c = len(ks), max(ks), 2**depth
    feats = np.zeros((nl, kmax, c - 1), np.int32)
    thr = np.full((nl, kmax, c - 1), np.inf, np.float32)
    lut = np.zeros((nl, kmax, c, nmax), np.float32)
    bias = np.zeros((nl, nmax), np.float32)
    for l, k in enumerate(ks):
        n = n_out if l == nl - 1 else ks[l + 1] * v
        feats[l, :k] = rng.integers(0, v, size=(k, c - 1))
        thr[l, :k] = rng.normal(size=(k, c - 1))
        lut[l, :k, :, :n] = rng.normal(size=(k, c, n)) * 0.3
        bias[l, :n] = rng.normal(size=n) * 0.1
    return dict(x=rng.normal(size=(t, ks[0], v)).astype(np.float32),
                features=feats, thresholds=thr, lut=lut, bias=bias)


def _torch(p):
    return {k: torch.as_tensor(v) for k, v in p.items()}


def _onehot(features, v):
    return prepare_feat_onehot(jnp.asarray(features), v)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shape", BANK_SHAPES)
def test_bank_kernel_matches_pallas(shape, strategy):
    t, k, v, depth, n = shape
    p = _bank_problem(sum(shape), *shape)
    want = np.asarray(fuzzy_lut_pallas(
        jnp.asarray(p["x"]), _onehot(p["features"], v), jnp.asarray(p["thresholds"]),
        jnp.asarray(p["lut"]), depth=depth, interpret=True, strategy=strategy))
    tp = _torch(p)
    before = dict(_lib.LAUNCHES)
    y, leaves = K.fuzzy_lut(tp["x"], tp["features"], tp["thresholds"], tp["lut"],
                            return_leaves=True)
    assert _lib.LAUNCHES == before            # CPU tensors: plain version, no launch
    want_leaves = np.asarray(tree_descent_ref(
        jnp.asarray(p["x"]), jnp.asarray(p["features"]), jnp.asarray(p["thresholds"])))
    np.testing.assert_array_equal(leaves.numpy(), want_leaves)
    np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)
    oracle = fuzzy_lut_matmul_ref(jnp.asarray(p["x"]), jnp.asarray(p["features"]),
                                  jnp.asarray(p["thresholds"]), jnp.asarray(p["lut"]))
    np.testing.assert_allclose(y.numpy(), np.asarray(oracle), rtol=TOL, atol=TOL)


def test_quantize_lut_int8_bit_exact():
    rng = np.random.default_rng(3)
    lut = rng.normal(size=(6, 8, 5)).astype(np.float32) * 3.0
    lut[2] = 0.0                                     # degenerate all-zero group
    lut[4, 1, 1] = 0.5 * (lut[4].max() / 127.0)      # near a rounding tie
    q, s = Q.quantize_lut_int8(torch.as_tensor(lut))
    jq, js = jax_quantize_lut_int8(jnp.asarray(lut))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shape", BANK_SHAPES)
def test_bank_q8_kernel_matches_pallas(shape, strategy):
    t, k, v, depth, n = shape
    p = _bank_problem(sum(shape) + 1, *shape)
    jq, js = jax_quantize_lut_int8(jnp.asarray(p["lut"]))
    want = np.asarray(fuzzy_lut_q8_pallas(
        jnp.asarray(p["x"]), _onehot(p["features"], v), jnp.asarray(p["thresholds"]),
        jq, js, depth=depth, interpret=True, strategy=strategy))
    tp = _torch(p)
    q, s = Q.quantize_lut_int8(tp["lut"])
    y = Q.fuzzy_lut_q8(tp["x"], tp["features"], tp["thresholds"], q, s)
    np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)


def _stack_q8(lut):
    """Per-(layer, group) int8 codes + scales of a padded stack, as the
    engines hold them."""
    nl, kmax, c, nmax = lut.shape
    return jax_quantize_lut_int8(jnp.asarray(lut.reshape(nl * kmax, c, nmax)))


# ks with Kmax padding (layers 1..3 pad 4 → 6) and a ragged chain
STACKS = [dict(t=16, ks=(6, 4, 4, 4), v=2, depth=3, nmax=8, n_out=3),
          dict(t=21, ks=(5, 3, 7), v=3, depth=2, nmax=21, n_out=11)]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("geom", STACKS, ids=["mlp-like", "ragged"])
def test_stack_kernels_match_pallas(geom, strategy):
    ks, n_out, depth = geom["ks"], geom["n_out"], geom["depth"]
    p = _stack_problem(7, **geom)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    feat_oh = prepare_feat_onehot(j["features"], geom["v"])
    want = np.asarray(fuzzy_lut_stack_pallas(
        j["x"], feat_oh, j["thresholds"], j["lut"], j["bias"], depth=depth, ks=ks,
        n_out=n_out, interpret=True, strategy=strategy))
    tp = _torch(p)
    y, leaves = K.fuzzy_lut_stack(tp["x"], tp["features"], tp["thresholds"],
                                  tp["lut"], tp["bias"], ks=ks, n_out=n_out,
                                  return_leaves=True)
    assert leaves.shape == (len(ks), geom["t"], max(ks))
    np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)

    jq, js = _stack_q8(p["lut"])
    nl, kmax = len(ks), max(ks)
    want_q8 = np.asarray(fuzzy_lut_stack_q8_pallas(
        j["x"], feat_oh, j["thresholds"], jq.reshape(p["lut"].shape),
        js.reshape(nl, kmax), j["bias"], depth=depth, ks=ks, n_out=n_out,
        interpret=True, strategy=strategy))
    q = torch.as_tensor(np.array(jq)).reshape(p["lut"].shape).contiguous()
    s = torch.as_tensor(np.array(js)).reshape(nl, kmax).contiguous()
    y8 = Q.fuzzy_lut_stack_q8(tp["x"], tp["features"], tp["thresholds"], q, s,
                              tp["bias"], ks=ks, n_out=n_out)
    np.testing.assert_allclose(y8.numpy(), want_q8, rtol=TOL, atol=TOL)


def test_stack_equals_chained_single_banks():
    """Stacked ≡ the per-bank kernel chained per layer (re-partition + bias
    between layers), leaves included — mirrors tests/test_kernels.py."""
    geom = STACKS[0]
    ks, v, n_out, t = geom["ks"], geom["v"], geom["n_out"], geom["t"]
    tp = _torch(_stack_problem(11, **geom))
    y, leaves = K.fuzzy_lut_stack(tp["x"], tp["features"], tp["thresholds"],
                                  tp["lut"], tp["bias"], ks=ks, n_out=n_out,
                                  return_leaves=True)
    h = tp["x"]
    for l, k in enumerate(ks):
        n = n_out if l == len(ks) - 1 else ks[l + 1] * v
        yl, ll = K.fuzzy_lut(h.contiguous(), tp["features"][l, :k].contiguous(),
                             tp["thresholds"][l, :k].contiguous(),
                             tp["lut"][l, :k, :, :n].contiguous(), return_leaves=True)
        assert torch.equal(ll, leaves[l, :, :k])
        yl = yl + tp["bias"][l, :n]
        if l + 1 < len(ks):
            h = yl.reshape(t, ks[l + 1], v)
    torch.testing.assert_close(y, yl, rtol=TOL, atol=TOL)


def test_wrappers_refuse_bad_operands():
    tp = _torch(_bank_problem(5, 8, 4, 2, 3, 6))
    with pytest.raises(ValueError, match="int32"):
        K.fuzzy_lut(tp["x"], tp["features"].long(), tp["thresholds"], tp["lut"])
    with pytest.raises(ValueError, match="contiguous"):
        K.fuzzy_lut(tp["x"].transpose(0, 1), tp["features"], tp["thresholds"], tp["lut"])
    with pytest.raises(ValueError, match="power of two"):
        K.fuzzy_lut(tp["x"], tp["features"][:, :6].contiguous(),
                    tp["thresholds"][:, :6].contiguous(), tp["lut"][:, :7].contiguous())
    sp = _torch(_stack_problem(5, **STACKS[0]))
    args = (sp["x"], sp["features"], sp["thresholds"], sp["lut"], sp["bias"])
    with pytest.raises(ValueError, match="ks has 3 entries"):
        K.fuzzy_lut_stack(*args, ks=(6, 4, 4), n_out=3)
    with pytest.raises(ValueError, match="ks\\[0\\]"):
        K.fuzzy_lut_stack(*args, ks=(4, 4, 4, 4), n_out=3)
    with pytest.raises(ValueError, match="Nmax"):
        K.fuzzy_lut_stack(*args, ks=(6, 4, 4, 4), n_out=9)


def test_kernel_library_raises_without_cuda():
    """No silent CPU: without a card the loader raises instead of handing
    back anything that could stand in for the kernel."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in ("fuzzy_lut_f32", "fuzzy_lut_q8", "fuzzy_lut_stack_f32", "fuzzy_lut_stack_q8"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _lib.library(fn)


def test_layer_wrappers_match_reference_and_memoize():
    """``fuzzy_lut_matmul``/``_q8`` on a PegasusLinear with leading batch
    dims and a bias, against the reference's wrappers; the layout and the
    int8 quantization are built once per layer."""
    from repro.core import init_pegasus_linear as jax_init
    from repro.kernels.fuzzy_lut import ops as jops
    from repro_torch.core.amm import init_pegasus_linear
    from repro_torch.kernels.fuzzy_lut import ops

    rng = np.random.default_rng(16)
    w = rng.normal(size=(12, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    calib = rng.normal(size=(256, 12)).astype(np.float32)
    layer = init_pegasus_linear(w, b, calib, group_size=3, depth=3, lut_bits=None,
                                device="cpu")
    ref = jax_init(w, b, calib, group_size=3, depth=3, lut_bits=None)
    x = rng.normal(size=(3, 5, 12)).astype(np.float32)
    for fn, jfn in ((ops.fuzzy_lut_matmul, jops.fuzzy_lut_matmul),
                    (ops.fuzzy_lut_matmul_q8, jops.fuzzy_lut_matmul_q8)):
        got = fn(layer, torch.as_tensor(x))
        assert got.shape == (3, 5, 7)
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(ref, jnp.asarray(x), interpret=True)),
                                   rtol=1e-4, atol=1e-4)
    builds, quants = ops.LAYOUT_STATS["layout_builds"], ops.QUANT_STATS["quantize_calls"]
    ops.fuzzy_lut_matmul_q8(layer, torch.as_tensor(x))
    ops.fuzzy_lut_matmul(layer, torch.as_tensor(x))
    assert ops.LAYOUT_STATS["layout_builds"] == builds
    assert ops.QUANT_STATS["quantize_calls"] == quants


# ---------------------------------------------------------------------------
# The int8 kernels' launch planner (plain Python; the kernel runs on the card)
# ---------------------------------------------------------------------------


def _q8_bulk_bytes(s, depth, nmax):
    """The bytes the kernel's bulk copies bring for stage ``s``: what its
    barrier must expect (expecting more, the wait would never end)."""
    k, c = s.groups, 2**depth
    parts = {Q.B_FEAT: 4 * k * (c - 1) if s.flags & Q.TREES else 0,
             Q.B_THR: 4 * k * (c - 1) if s.flags & Q.TREES else 0,
             Q.B_SCALE: 4 * k if s.flags & Q.GATHER else 0,
             Q.B_BIAS: 4 * s.nt if s.flags & Q.GATHER else 0,
             Q.B_LUT: (k * c * (nmax if s.flags & Q.FULLROW else s.nt)
                       if s.flags & Q.LUT else 0)}
    return sum(n for bit, n in parts.items() if s.bulk & bit)


def _check_q8_plan(plan, ks, v, n_out, depth, nmax):
    """Per layer: one descent before its columns, the layer's columns
    covered once in order, every stage within a slot, the launch within a
    block's shared memory."""
    assert plan.smem_bytes(plan.max_rows) <= Q.Q8_SMEM_BYTES
    assert plan.slot_bytes % 16 == 0
    by_layer = {}
    for s in plan.stages:
        assert s.nbytes <= plan.slot_bytes
        assert s.tx == _q8_bulk_bytes(s, depth, nmax)
        by_layer.setdefault(s.layer, []).append(s)
    assert list(by_layer) == list(range(len(ks)))
    assert [i for a, n in plan.fills for i in range(a, a + n)] == list(range(len(plan.stages)))
    for a, n in plan.fills:
        assert sum(s.nbytes for s in plan.stages[a:a + n]) <= plan.slot_bytes
    for l, stages in by_layer.items():
        n_eff = n_out if l == len(ks) - 1 else ks[l + 1] * v
        assert stages[0].flags & Q.DESCENT
        assert sum(bool(s.flags & Q.DESCENT) for s in stages) == 1
        cols = [(s.n0, s.nt) for s in stages if s.flags & Q.GATHER]
        covered = [n for n0, nt in cols for n in range(n0, n0 + nt)]
        assert covered == list(range(n_eff))
    return by_layer


def test_q8_plan_stages_mlp_b_layers_whole():
    """MLP-B (v=2, depth 6, hidden 32): each layer, stacked or as a bank,
    is a bulk-copied trees stage and one bulk-copied stage with the whole
    int8 table (the descent overlaps the table's copy)."""
    trees = Q.DESCENT | Q.TREES
    whole = Q.GATHER | Q.LUT | Q.FULLROW
    plan = Q.plan_q8((8, 16, 16, 16), 2, 6, 16, 32, 3, has_bias=True)
    _check_q8_plan(plan, (8, 16, 16, 16), 2, 3, 6, 32)
    assert [s.flags for s in plan.stages] == [trees, whole] * 4
    assert all(s.lpitch == 32 for s in plan.stages)
    tables = Q.B_SCALE | Q.B_BIAS | Q.B_LUT
    assert [s.bulk for s in plan.stages] == [Q.B_FEAT | Q.B_THR, tables] * 3 + [
        Q.B_FEAT | Q.B_THR, tables & ~Q.B_BIAS]
    assert plan.stages[2].tx == 2 * 4 * 16 * 63
    assert plan.stages[3].tx == 4 * 16 + 4 * 32 + 16 * 64 * 32
    assert plan.rows_for(4096, 132) == 32
    for k, n in ((8, 32), (16, 32), (16, 32), (16, 3)):
        bank = Q.plan_q8((k,), 2, 6, k, n, n, has_bias=False)
        assert [s.flags for s in bank.stages] == [trees, whole]


@pytest.mark.parametrize("geom", [((16,), 2, 6, 16, 2048, 2048, False),
                                  ((16, 16), 2, 6, 16, 1024, 1024, True),
                                  ((40, 100, 30), 4, 7, 100, 400, 333, True)],
                         ids=["bank-2048", "stack-1024", "ragged"])
def test_q8_plan_tiles_cover_columns_within_a_slot(geom):
    ks, v, depth, kmax, nmax, n_out, has_bias = geom
    plan = Q.plan_q8(ks, v, depth, kmax, nmax, n_out, has_bias=has_bias)
    by_layer = _check_q8_plan(plan, ks, v, n_out, depth, nmax)
    last = by_layer[len(ks) - 1]
    assert len(last) > 2                       # a trees stage and column tiles
    assert last[0].flags == Q.DESCENT | Q.TREES
    tiles = [s for s in last if s.flags & Q.GATHER]
    assert all(s.flags & Q.LUT and not s.flags & Q.FULLROW for s in tiles)
    assert all(s.pitch == tiles[0].nt == s.lpitch for s in tiles)
    assert all(s.nt % 16 == 0 for s in tiles[:-1])


def test_q8_plan_bulk_copy_needs_16_byte_addresses_and_sizes():
    # aligned, 16-byte multiples: every part by bulk copy
    t, s = Q.plan_q8((16,), 2, 6, 16, 32, 32, has_bias=False).stages
    assert (t.bulk, s.bulk) == (Q.B_FEAT | Q.B_THR, Q.B_SCALE | Q.B_LUT)
    assert t.tx == t.nbytes and s.tx == s.nbytes
    # a table 4 bytes past a 16-byte boundary: that part is copied by the warp
    s = Q.plan_q8((16,), 2, 6, 16, 32, 32, has_bias=False,
                  align=(0, 0, 0, 0, 4)).stages[1]
    assert s.bulk == Q.B_SCALE
    assert s.tx == s.nbytes - 16 * 64 * 32
    # C=2 trees (one node, 12 bytes for K=3) and 3 scales: nothing is a
    # multiple of 16, as in the T=1 / K=3 / d=1 / N=1 card test
    stages = Q.plan_q8((3,), 2, 1, 3, 1, 1, has_bias=False).stages
    assert all(s.bulk == 0 and s.tx == 0 for s in stages)
    # column tiles: bulk row segments only where Nmax, the tile's first
    # column and its width are multiples of 16
    tiles = [t for t in Q.plan_q8((16,), 2, 6, 16, 2048, 2040, has_bias=False).stages
             if t.flags & Q.GATHER]
    assert all(t.bulk & Q.B_LUT for t in tiles[:-1])
    assert not tiles[-1].bulk & Q.B_LUT        # last tile is 2040 mod 96 = 24 wide
    assert not any(t.bulk & Q.B_LUT for t in Q.plan_q8(
        (16,), 2, 6, 16, 2047, 2047, has_bias=False).stages)


def test_q8_plan_reads_through_l1_where_no_tile_fits():
    """K=256 groups of depth-6 trees: neither the trees (129 KB) nor 16
    LUT columns (262 KB) fit a slot; one stage walks and gathers from
    global memory."""
    plan = Q.plan_q8((256,), 2, 6, 256, 40, 40, has_bias=False)
    _check_q8_plan(plan, (256,), 2, 40, 6, 40)
    assert [s.flags for s in plan.stages] == [Q.DESCENT | Q.GATHER]


@pytest.mark.parametrize("v", [1, 2, 4])
@pytest.mark.parametrize("depth", [1, 4, 6, 8])
def test_q8_plan_for_every_geometry_the_stack_admits(v, depth):
    """Every geometry ``stack_fits`` admits, up to Nmax = 2048 (the fusion
    cap), gets a plan: the int8 kernel refuses no stack the f32 one takes."""
    rng = np.random.default_rng(100 * v + depth)
    planned = 0
    for _ in range(60):
        nl = int(rng.integers(1, 6))
        nmax = int(rng.choice([1, 3, 16, 32, 70, 256, 1000, 2048]))
        kcap = max(1, nmax // v)
        k0 = int(rng.integers(1, 4 * kcap + 1))
        ks = (k0,) + tuple(int(rng.integers(1, kcap + 1)) for _ in range(nl - 1))
        kmax = max(ks)
        n_out = int(rng.integers(1, nmax + 1))
        if not K.stack_fits(k0, v, kmax, nmax, nl):
            continue
        plan = Q.plan_q8(ks, v, depth, kmax, nmax, n_out, has_bias=True)
        _check_q8_plan(plan, ks, v, n_out, depth, nmax)
        planned += 1
    assert planned > 20
    # the extreme the fusion cap admits: Nmax = 2048 at the widest ks
    ks = (2048 // v,) * 3
    assert K.stack_fits(ks[0], v, ks[0], 2048, 3)
    _check_q8_plan(Q.plan_q8(ks, v, depth, ks[0], 2048, 2048, has_bias=True), ks, v, 2048,
                   depth, 2048)


# ---------------------------------------------------------------------------
# The f32 kernels' launch planner (plain Python; the kernel runs on the card)
# ---------------------------------------------------------------------------


def _check_f32_plan(plan, ks, v, depth, t=4096, n_sm=132):
    """One row per warp within a block's shared memory; the row in
    registers exactly when every layer's input fits a warp; a row of LUT
    row indices that covers every layer's groups in whole chunks; resident
    trees node-major with a pitch that is a multiple of 16 and covers every
    layer's groups."""
    assert 1 <= plan.max_rows <= K.F32_MAX_ROWS
    assert plan.smem_bytes(plan.max_rows) <= K.SMEM_PER_BLOCK
    assert plan.regs == all(k * v <= 32 for k in ks)
    if not plan.regs and len(ks) > 1:
        assert plan.width >= max(k * v for k in ks) and plan.width % 4 == 0
    else:
        assert plan.width == 0
    assert plan.kstride % K.F32_CHUNK == 0 and max(ks) <= plan.kstride < max(ks) + K.F32_CHUNK
    if plan.kpad:
        assert plan.kpad % K.TREE_PITCH == 0 and plan.kpad >= max(ks)
        assert plan.tree_bytes == 16 * (2**depth - 1) * plan.kpad * len(ks)
    else:
        assert plan.tree_bytes == 0
    rows, grid, threads, smem = K.f32_launch_shape(plan, t, n_sm)
    assert rows * grid >= t > rows * (grid - 1)
    assert threads == 32 * rows <= 1024 and smem <= K.SMEM_PER_BLOCK


def test_f32_plan_mlp_b_row_in_registers_trees_on_chip():
    """MLP-B (v=2, depth 6, hidden 32), stacked or as banks: the row in
    registers, every layer's trees node-major in shared memory with a pitch
    of 16 (beside their raw copies), 16 LUT row indices per warp, and the
    bucket of 4096 rows in one wave of 128 blocks of 32 warps on 132 SMs."""
    plan = K.plan_f32((8, 16, 16, 16), 2, 6, 16)
    _check_f32_plan(plan, (8, 16, 16, 16), 2, 6)
    assert (plan.regs, plan.width, plan.kstride, plan.kpad) == (True, 0, 16, 16)
    trees = 4 * 2 * 63 * 16 * 8
    assert plan.tree_bytes == trees
    assert K.f32_launch_shape(plan, 4096, 132) == (32, 128, 1024, trees + 32 * 64)
    assert K.f32_launch_shape(plan, 1, 132) == (1, 1, 32, trees + 64)
    for k in (8, 16):
        bank = K.plan_f32((k,), 2, 6, k)
        _check_f32_plan(bank, (k,), 2, 6)
        assert (bank.regs, bank.kpad, bank.tree_bytes) == (True, 16, 2 * 63 * 16 * 8)


@pytest.mark.parametrize("shape", [(16, 2, 6), (256, 2, 6), (13, 4, 5), (3, 2, 1)],
                         ids=["mlp-b", "k256", "ragged", "t1"])
def test_f32_plan_banks(shape):
    """A lone bank keeps no activation row on chip: in registers, or read
    from global memory. The K=256 bank's trees (126 KiB, twice over with
    their raw copy) do not fit: its descent reads them through L1."""
    k, v, depth = shape
    plan = K.plan_f32((k,), v, depth, k)
    _check_f32_plan(plan, (k,), v, depth)
    assert plan.width == 0
    if k == 256:
        assert plan.kstride == 256 and plan.kpad == 0 and plan.max_rows == 32


def test_f32_plan_reads_trees_through_l1_where_they_do_not_fit():
    plan = K.plan_f32((200, 120), 1, 8, 200)
    _check_f32_plan(plan, (200, 120), 1, 8)
    assert plan.kpad == 0 and plan.tree_bytes == 0
    assert (plan.width, plan.kstride) == (200, 208)


@pytest.mark.parametrize("v", [1, 2, 4])
@pytest.mark.parametrize("depth", [1, 4, 6, 8])
def test_f32_plan_for_every_geometry_the_stack_admits(v, depth):
    """Every geometry ``stack_fits`` admits, up to Nmax = 2048 (the fusion
    cap), gets an f32 plan: the redesign refuses no stack that fuses."""
    rng = np.random.default_rng(200 * v + depth)
    planned = 0
    for _ in range(60):
        nl = int(rng.integers(1, 6))
        nmax = int(rng.choice([1, 3, 16, 32, 70, 256, 1000, 2048]))
        kcap = max(1, nmax // v)
        k0 = int(rng.integers(1, 4 * kcap + 1))
        ks = (k0,) + tuple(int(rng.integers(1, kcap + 1)) for _ in range(nl - 1))
        kmax = max(ks)
        if not K.stack_fits(k0, v, kmax, nmax, nl):
            continue
        _check_f32_plan(K.plan_f32(ks, v, depth, kmax), ks, v, depth,
                        t=int(rng.integers(1, 9000)))
        planned += 1
    assert planned > 20
    ks = (2048 // v,) * 3
    assert K.stack_fits(ks[0], v, ks[0], 2048, 3)
    _check_f32_plan(K.plan_f32(ks, v, depth, ks[0]), ks, v, depth)
