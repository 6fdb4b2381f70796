"""The port's LM training path (``lm_loss``, remat, the AdamW train step,
``TrainLoop``, the CLI) against the JAX reference, on the CPU.

Weights are the reference's ``init_model(PRNGKey(0))`` in f32, carried
across with ``repro_torch.interop.lm_params_from_arrays``; both packages
draw the same ``synthetic_batches``. The oracle is the reference's
unsharded ``jax.jit(make_train_step(cfg))``: its own ``TrainLoop`` fails on
a ``(1, 1)`` mesh before it takes a step.

Tolerances (f32 in both, sums in another order, ~1e-6 relative):
loss within 1e-5 relative; grad_norm within 1e-4 relative; each gradient
and each Adam first moment ``m`` within 1e-4 by relative L2 per leaf; the
second moment ``v`` (squares: twice the relative error) within 2e-4. The
Hymba family is the loosest, ~3e-5 per gradient leaf (its Mamba state).
The parameters are held by what the steps moved them: per leaf, the change
``p_after - p_before`` against the reference's change, by relative L2
within 1e-3 (measured on the ten smoke architectures: at most 2.5e-4,
Hymba and xLSTM the loosest). A step that left a weight where it was is
off by 1. Most tests pass both packages one constant learning rate, the
default schedule's peak of 3e-4: the schedule's warmup starts at 0 (lr
0, 1.5e-6, 3e-6 over the first three steps), too little to tell a moved
weight from a still one by its absolute value. The ``TrainLoop`` test keeps the default
schedule, where a schedule read one step off doubles the change.
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import train as jtrain
from repro.models import transformer as jtr
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch.configs import registry as treg
from repro_torch.interop import lm_arrays_from_params, lm_params_from_arrays
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttr
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.optimizer import adamw_init

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LOSS_RTOL, NORM_RTOL, GRAD_REL, V_REL, MOVE_REL = 1e-5, 1e-4, 1e-4, 2e-4, 1e-3
LR = 3e-4
B, S = 2, 16


def _models(arch: str):
    jcfg, cfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    jp = jtr.init_model(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, cfg, jp, lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jp), device=CPU)


def _leaves(tree) -> list:
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


def _assert_rel_l2(got, want, tol: float, what: str):
    """Per leaf: ||got - want|| <= tol · ||want|| (trees of equal keys)."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        err = np.linalg.norm(g - w)
        assert err <= tol * np.linalg.norm(w) + 1e-12, \
            f"{what} leaf {i}: relative L2 {err / max(np.linalg.norm(w), 1e-30):.3e} > {tol}"


def _const_lr(step):
    return LR


def _assert_moved(cfg, tp_before: dict, tp, jp_before, jp, what: str):
    """Per leaf, the port's change of the params against the reference's:
    relative L2 within MOVE_REL. ``tp_before`` is
    ``lm_arrays_from_params`` of the port's params before the steps."""
    t0, t1 = _leaves(tp_before), _leaves(lm_arrays_from_params(cfg, tp))
    j0, j1 = _leaves(jp_before), _leaves(jp)
    assert len(t0) == len(t1) == len(j0) == len(j1), what
    for i, (a0, a1, b0, b1) in enumerate(zip(t0, t1, j0, j1)):
        want = b1 - b0
        assert np.linalg.norm(want) > 0, (what, i)
        err = np.linalg.norm((a1 - a0) - want) / np.linalg.norm(want)
        assert err <= MOVE_REL, f"{what} leaf {i}: change off by relative L2 {err:.3e}"


def _close(got, want, rtol: float, what: str):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)), \
        f"{what}: {float(got)} vs {float(want)}"


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_train_step_matches_reference(arch):
    """Three train steps at one constant learning rate: loss, grad_norm,
    every gradient, m and v after each; what the three moved the params."""
    jcfg, cfg, jp, tp = _models(arch)
    jp0, tp0 = jp, lm_arrays_from_params(cfg, tp)
    jo, to = jadamw_init(jp), adamw_init(dict(tp.named_parameters()))
    jstep = jtrain.make_train_step(jcfg, lr_fn=_const_lr)
    jloss = lambda p, b: jtr.lm_loss(jcfg, p, b)   # noqa: E731
    ref = jax.jit(lambda p, o, b: (jax.grad(jloss)(p, b), jstep(p, o, b)))
    tstep = ttrain.make_train_step(cfg, lr_fn=_const_lr)
    jb, tb = jtrain.synthetic_batches(jcfg, B, S), ttrain.synthetic_batches(cfg, B, S)
    for i in range(3):
        bj, bt = next(jb), next(tb)
        jgrads, (jp, jo, jm) = ref(jp, jo, bj)
        tp.requires_grad_(True)
        loss, tgrads = ttrain.loss_and_grads(cfg, tp, bt)
        tp, to, tm = tstep(tp, to, bt)
        _close(loss, jm["loss"], LOSS_RTOL, f"{arch} step {i} loss (loss_and_grads)")
        _close(tm["loss"], jm["loss"], LOSS_RTOL, f"{arch} step {i} loss")
        _close(tm["grad_norm"], jm["grad_norm"], NORM_RTOL, f"{arch} step {i} grad_norm")
        assert int(tm["step"]) == int(jm["step"]) == i + 1
        _assert_rel_l2(lm_arrays_from_params(cfg, tgrads), jgrads, GRAD_REL,
                       f"{arch} step {i} grads")
        _assert_rel_l2(lm_arrays_from_params(cfg, to.m), jo.m, GRAD_REL, f"{arch} step {i} m")
        _assert_rel_l2(lm_arrays_from_params(cfg, to.v), jo.v, V_REL, f"{arch} step {i} v")
    _assert_moved(cfg, tp0, tp, jp0, jp, f"{arch} params after 3 steps")


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "phi3_5_moe", "xlstm_1_3b", "hymba_1_5b",
                                  "whisper_large_v3"])
def test_remat_policies_change_memory_not_values(arch, monkeypatch):
    """``"nothing"``, ``"dots"`` and no remat give the same loss and
    gradients to the bit; the first two run each layer again in the
    backward, no remat once, and without autograd remat is skipped."""
    cfg = treg.smoke_config(arch)
    params = ttr.init_model(cfg, 0, dtype=torch.float32, device=CPU).requires_grad_(True)
    batch = next(ttrain.synthetic_batches(cfg, B, S))
    calls = []
    layer_forward = ttr._layer_forward

    def counted(*args, **kwargs):
        calls.append(1)
        return layer_forward(*args, **kwargs)

    monkeypatch.setattr(ttr, "_layer_forward", counted)
    layers = cfg.num_layers + cfg.encoder_layers
    runs = {}
    for policy in ("nothing", "dots", "none"):
        calls.clear()
        runs[policy] = ttrain.loss_and_grads(cfg, params, batch, remat_policy=policy)
        runs[policy] += (len(calls),)
    calls.clear()
    with torch.no_grad():
        ttr.forward_train(cfg, params, batch, remat_policy="nothing")
    assert len(calls) == layers
    loss0, g0, n0 = runs["nothing"]
    assert n0 == runs["dots"][2] == 2 * layers and runs["none"][2] == layers
    for policy in ("dots", "none"):
        loss, g, _ = runs[policy]
        assert torch.equal(loss, loss0), policy
        assert all(torch.equal(g[k], g0[k]) for k in g0), policy


def test_lm_loss_terms():
    """The loss term by term: cross-entropy over the padded vocab, the
    z-loss and the MoE auxiliary loss, against the reference's
    ``lm_loss`` (with and without remat, z_loss and aux_weight set), on a
    vocab of 250 padded to 256."""
    jcfg = dataclasses.replace(jreg.smoke_config("phi3_5_moe"), vocab_size=250)
    cfg = dataclasses.replace(treg.smoke_config("phi3_5_moe"), vocab_size=250)
    jp = jtr.init_model(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jp), device=CPU)
    bt = next(ttrain.synthetic_batches(cfg, B, S))
    bj = {k: jnp.asarray(v.numpy()) for k, v in bt.items()}
    for kw in ({}, {"z_loss": 0.5, "aux_weight": 2.0}, {"z_loss": 0.0, "aux_weight": 0.0}):
        want = jtr.lm_loss(jcfg, jp, bj, **kw)
        for policy in ("nothing", "none"):
            _close(ttr.lm_loss(cfg, tp, bt, remat_policy=policy, **kw), want, LOSS_RTOL,
                   f"lm_loss {kw} {policy}")
    logits, aux = ttr.forward_train(cfg, tp, bt)
    assert logits.shape[-1] == ttr.padded_vocab(cfg) > cfg.vocab_size
    assert float(aux) > 0


def test_microbatches_match_reference():
    """``microbatches=2``: the reference's scan over batch slices against the
    port's loop, loss, grad_norm, m, v and what 3 steps moved the params
    (a constant learning rate and a weight decay of 0.5 passed to both);
    and the loss close to the full batch's, as the reference's own test
    holds."""
    jcfg, cfg, jp, tp = _models("qwen2_vl_2b")
    jp0, tp0 = jp, lm_arrays_from_params(cfg, tp)
    jo, to = jadamw_init(jp), adamw_init(dict(tp.named_parameters()))
    kw = dict(microbatches=2, lr_fn=_const_lr, weight_decay=0.5)
    jstep = jax.jit(jtrain.make_train_step(jcfg, **kw))
    tstep = ttrain.make_train_step(cfg, **kw)
    jb, tb = jtrain.synthetic_batches(jcfg, 4, S), ttrain.synthetic_batches(cfg, 4, S)
    full = ttrain.loss_and_grads(cfg, tp.requires_grad_(True), next(ttrain.synthetic_batches(
        cfg, 4, S)))[0]
    for i in range(3):
        jp, jo, jm = jstep(jp, jo, next(jb))
        tp, to, tm = tstep(tp, to, next(tb))
        if i == 0:
            assert float(tm["loss"]) == pytest.approx(float(full), rel=1e-4)
        _close(tm["loss"], jm["loss"], LOSS_RTOL, f"step {i} loss")
        _close(tm["grad_norm"], jm["grad_norm"], NORM_RTOL, f"step {i} grad_norm")
        _assert_rel_l2(lm_arrays_from_params(cfg, to.m), jo.m, GRAD_REL, f"step {i} m")
        _assert_rel_l2(lm_arrays_from_params(cfg, to.v), jo.v, V_REL, f"step {i} v")
    _assert_moved(cfg, tp0, tp, jp0, jp, "params after 3 microbatched steps")
    with pytest.raises(ValueError, match="microbatches"):
        ttrain.make_train_step(cfg, microbatches=3)(tp, to, next(tb))


def test_grad_compression_small_error():
    """bf16 gradient compression: under 1% relative error on the gradients
    (the reference's requirement), and the compressed step against the
    reference's compressed step."""
    jcfg, cfg, jp, tp = _models("granite_20b")
    batch = next(ttrain.synthetic_batches(cfg, B, S))
    _, grads = ttrain.loss_and_grads(cfg, tp.requires_grad_(True), batch)
    comp = {k: g.to(torch.bfloat16).to(torch.float32) for k, g in grads.items()}
    num = sum(float(torch.sum((grads[k] - comp[k]) ** 2)) for k in grads)
    den = sum(float(torch.sum(g ** 2)) for g in grads.values())
    assert (num / den) ** 0.5 < 0.01

    jp0, tp0 = jp, lm_arrays_from_params(cfg, tp)
    jo, to = jadamw_init(jp), adamw_init(dict(tp.named_parameters()))
    jstep = jax.jit(jtrain.make_train_step(jcfg, grad_compression="bf16", lr_fn=_const_lr))
    tstep = ttrain.make_train_step(cfg, grad_compression="bf16", lr_fn=_const_lr)
    jb, tb = jtrain.synthetic_batches(jcfg, B, S), ttrain.synthetic_batches(cfg, B, S)
    for i in range(2):
        jp, jo, jm = jstep(jp, jo, next(jb))
        tp, to, tm = tstep(tp, to, next(tb))
        _close(tm["loss"], jm["loss"], LOSS_RTOL, f"step {i} loss")
        _close(tm["grad_norm"], jm["grad_norm"], NORM_RTOL, f"step {i} grad_norm")
    _assert_moved(cfg, tp0, tp, jp0, jp, "params after 2 compressed steps")
    with pytest.raises(ValueError, match="grad_compression"):
        ttrain.make_train_step(cfg, grad_compression="int8")


def test_synthetic_batches_match_reference():
    """The same numpy draws in the same order: tokens/labels, the stub
    frontend's embeds, and Whisper's decoder tokens cut to max_decoder_len."""
    for arch in ("deepseek_coder_33b", "qwen2_vl_2b", "whisper_large_v3"):
        jb = jtrain.synthetic_batches(jreg.smoke_config(arch), 2, 40, seed=5)
        tb = ttrain.synthetic_batches(treg.smoke_config(arch), 2, 40, seed=5)
        for _ in range(3):
            want, got = next(jb), next(tb)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype in (torch.int32, torch.float32)
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_trainloop_runs_and_loss_finite(tmp_path):
    cfg = treg.smoke_config("deepseek_coder_33b")
    loop = ttrain.TrainLoop(cfg, device="cpu", ckpt_dir=str(tmp_path), ckpt_every=3)
    m = loop.run(ttrain.synthetic_batches(cfg, 2, 16), steps=4)
    assert np.isfinite(float(m["loss"]))
    assert tckpt.latest_step(str(tmp_path)) == 4
    assert tckpt.latest_steps(str(tmp_path)) == [3, 4]
    assert len(loop.step_times) == 4 and int(loop.opt.step) == 4


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "phi3_5_moe"])
def test_trainloop_matches_reference_steps(arch):
    """``TrainLoop`` over 3 steps against a loop of the reference's
    unsharded jitted steps from the loop's own initial weights, both on the
    default schedule: what the steps moved the params holds the loop's
    reading of the learning rate at each step."""
    jcfg, cfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    loop = ttrain.TrainLoop(cfg, device="cpu", seed=4)
    tp0 = lm_arrays_from_params(cfg, loop.params)
    jp = jp0 = jax.tree.map(jnp.asarray, tp0)
    jo = jadamw_init(jp)
    jstep = jax.jit(jtrain.make_train_step(jcfg))
    jb = jtrain.synthetic_batches(jcfg, B, S)
    for _ in range(3):
        jp, jo, jm = jstep(jp, jo, next(jb))
    tm = loop.run(ttrain.synthetic_batches(cfg, B, S), steps=3)
    _close(tm["loss"], jm["loss"], LOSS_RTOL, "loss at step 3")
    _close(tm["grad_norm"], jm["grad_norm"], NORM_RTOL, "grad_norm at step 3")
    _assert_rel_l2(lm_arrays_from_params(cfg, loop.opt.v), jo.v, V_REL, "v after 3 steps")
    _assert_moved(cfg, tp0, loop.params, jp0, jp, "params after 3 steps")


def test_crash_recovery_resumes_identically(tmp_path):
    """Train 6 steps straight vs 3 + 'crash' + restore + 3: same params
    (the reference's limits)."""
    cfg = treg.smoke_config("qwen2_vl_2b")

    def batches():
        return ttrain.synthetic_batches(cfg, 2, 16, seed=0)

    loop = ttrain.TrainLoop(cfg, device="cpu", ckpt_dir=str(tmp_path / "a"), ckpt_every=100)
    loop.run(batches(), steps=6)
    straight = {k: p.detach().clone() for k, p in loop.params.named_parameters()}

    d2 = str(tmp_path / "b")
    loop_a = ttrain.TrainLoop(cfg, device="cpu", ckpt_dir=d2, ckpt_every=3)
    loop_a.run(batches(), steps=3)          # checkpoints at step 3; "crash" here
    del loop_a
    loop_b = ttrain.TrainLoop(cfg, device="cpu", ckpt_dir=d2, ckpt_every=100)
    assert loop_b.start_step == 3 and int(loop_b.opt.step) == 3
    gen = batches()
    for _ in range(3):
        next(gen)
    loop_b.run(gen, steps=3)
    assert tckpt.latest_step(d2) == 6
    for k, p in loop_b.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), straight[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_cli_runs_on_cpu(tmp_path, capsys):
    metrics = ttrain.main(["--arch", "deepseek_coder_33b", "--smoke", "--steps", "2",
                           "--batch", "2", "--seq", "16", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)])
    assert set(metrics) == {"loss", "grad_norm", "step"}
    assert np.isfinite(metrics["loss"]) and metrics["step"] == 2
    assert tckpt.latest_step(str(tmp_path)) == 2
    assert "'loss'" in capsys.readouterr().out


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = treg.smoke_config("deepseek_coder_33b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.TrainLoop(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--arch", "deepseek_coder_33b", "--smoke", "--steps", "1"])


def test_lm_arrays_from_params_inverts_lm_params_from_arrays():
    for arch in ("whisper_large_v3", "phi3_5_moe", "xlstm_1_3b"):
        jcfg, cfg, jp, tp = _models(arch)
        want = jax.tree.map(np.asarray, jp)
        got = lm_arrays_from_params(cfg, tp)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="layers"):
        lm_arrays_from_params(treg.get_config(arch), tp)


def test_chip_smoke_train_phase_rehearses():
    """chip_smoke.py's phase 10 on the CPU at smoke width: TrainLoop steps
    with finite losses, the 2-layer step held CPU against CPU, remat,
    crash recovery, the checkpoint bit-equal, the nine smoke architectures."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    res = cs.train_phase(CPU, "the CPU (test)", rehearse=True)
    assert len(res["steps"]) == cs.TRAIN_REHEARSE["steps"]
    assert all(np.isfinite(s["loss"]) for s in res["steps"])
    assert res["remat"]["bit_equal"] == {"dots": True, "none": True}
    assert res["recovery"] == 0.0 and res["checkpoint"]["bytes"] > 0
    assert [a for a, _, _ in res["smoke"]] == [a for a in treg.ARCH_IDS if a != cs.LM_ARCH]
