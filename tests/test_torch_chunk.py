"""K optimizer steps per call: the port's chunked step (train/step.py,
chunk_steps), the trainer's chunk loop (steps_chunk, _chunk_scalars,
_process_chunk_outputs) and PairLoader.next_chunk, against K sequential
steps and against the JAX package's chunked step and trainer."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.config import MoDAConfig
from moda_tpu.train import step as JS
from moda_tpu.train import trainer as JT
from moda_tpu_torch.train import step as TS
from moda_tpu_torch.train import trainer as TT
from tests import torch_dist as TD


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chunk_step_fields_match_jax():
    assert TS.CHUNK_STEP_FIELDS == JS.CHUNK_STEP_FIELDS


def _per_step(K: int):
    """K steps' scalars that differ from step to step."""
    return [dict(progress=0.3 + 0.2 * j, loss_select=1 - (j == 2), root_update=1.0,
                 body_update=float(j != 1), shape_update=0.0, cvf_update=0.0,
                 sil_err_median=1e9 if j == 0 else 0.05, embed_alpha=6.0 + j)
            for j in range(K)]


@pytest.mark.parametrize("name,accu", [("init", 1), ("ft2", 1), ("init", 2)])
def test_chunked_step_is_k_sequential_steps(name, accu):
    """One call of K = 3 chunked steps against 3 calls of the step, from the
    same parameters, batches, per-step scalars and generator state (init;
    ft2: the fine pass, active sampling and the delta-skin MLP; init with
    accu_steps 2): parameters, the optimizer's count and moments, every aux
    and host output bit-identical, since the same operations run in the
    same order."""
    from moda_tpu_torch.train.optim import MoDAOptimizer

    K = 3
    runs = []
    for chunk in (1, K):
        cfg, model, _, extras = TD.case_inputs(name)
        opt = MoDAOptimizer(cfg, total_steps=100)
        step = TD.make_case_step(name, model, cfg, chunk=chunk, accu=accu, opt=opt)
        batches = [{k: torch.from_numpy(v) for k, v in TD.case_batch(name, cfg, 10 + j)[0].items()}
                   for j in range(K)]
        scal = _per_step(K)
        gen = torch.Generator().manual_seed(5)
        if chunk == 1:
            outs = [TD.one_step(step, b,
                                extras._replace(**{k: torch.tensor(v) for k, v in s.items()}),
                                generator=gen) for b, s in zip(batches, scal)]
            aux = {k: torch.stack([o[0][k] for o in outs]) for k in outs[0][0]}
            host = {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]}
        else:
            stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
            per_step = {f: torch.tensor([s[f] for s in scal], dtype=torch.float32)
                        for f in TS.CHUNK_STEP_FIELDS}
            aux, host = step(stacked, extras, per_step, generator=gen)
        runs.append((model, opt.state, aux, host))
    (m1, o1, a1, h1), (mK, oK, aK, hK) = runs
    assert a1.keys() == aK.keys() and h1.keys() == hK.keys()
    for k in a1:
        assert aK[k].shape[0] == K and torch.equal(a1[k], aK[k]), k
    for k in h1:
        assert torch.equal(h1[k], hK[k]), k
    for (n, p), (_, q) in zip(m1.named_parameters(), mK.named_parameters()):
        assert torch.equal(p, q), n
    assert int(o1.count) == int(oK.count) == K
    for k in o1.mu:
        assert torch.equal(o1.mu[k], oK.mu[k]) and torch.equal(o1.nu[k], oK.nu[k]), k
    assert not torch.equal(a1["lr"][0], a1["lr"][-1])  # the schedule moved
    assert len(set(a1["total_loss"].tolist())) == K


@pytest.mark.parametrize("debug", [False, True])
def test_trainer_steps_chunk_matches_jax(debug, monkeypatch):
    """Trainer.steps_chunk against the JAX trainer's on the CPU backend
    (auto gives 1 there), accu_steps 1 (under accu_steps the port's epoch
    counts calls, the JAX trainer's micro-steps: ROADMAP §3), at the
    recipe's 200 iterations and at a cut epoch of 30."""
    from types import SimpleNamespace

    for iters in (200, 30):
        monkeypatch.setattr(TT, "ITERS_PER_EPOCH", iters)
        monkeypatch.setattr(JT, "ITERS_PER_EPOCH", iters)
        for k in (0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 25, 30, 50, 64):
            kw = dict(steps_chunk=k, debug=debug)
            want = JT.Trainer.steps_chunk.fget(SimpleNamespace(cfg=MoDAConfig(**kw)))
            got = TT.Trainer.steps_chunk.fget(SimpleNamespace(cfg=TT.MoDAConfig(**kw)))
            assert got == want, (iters, kw, got, want)


class _FakeLoader:
    """Deterministic batches for both trainers: frame ids that move each
    call, and next_chunk as k next() calls stacked."""

    def __init__(self):
        self.n = 0

    def __next__(self):
        self.n += 1
        fid = ((np.arange(4) + self.n) % 6).astype(np.int32)
        return {"frameid": fid, "x": np.full((4, 2), self.n, np.float32)}

    def next_chunk(self, k):
        bl = [next(self) for _ in range(k)]
        return ({f: np.stack([b[f] for b in bl]) for f in bl[0]},
                [np.asarray(b["frameid"]) for b in bl])


def _fake_outputs(n: int, K: int):
    """Step outputs that feed the host bookkeeping: frame errors that
    change the silhouette median, gradient norms that trip nothing."""
    rng = np.random.default_rng(n)
    aux = {"total_loss": rng.uniform(size=K).astype(np.float32),
           "nerf_root_rts_g": np.ones(K, np.float32), "nerf_coarse_g": np.ones(K, np.float32),
           "shape_frozen": np.zeros(K, np.float32), "root_step_rejected": np.zeros(K, np.float32)}
    host = {"rtk": rng.normal(size=(K, 4, 4, 4)).astype(np.float32),
            "frame_err": rng.uniform(size=(K, 6)).astype(np.float32),
            "frame_cnt": (rng.uniform(size=(K, 6)) > 0.3).astype(np.float32)}
    return aux, host


def test_chunk_host_bookkeeping_matches_jax(tmp_path, monkeypatch):
    """The trainers' chunk loops on the same fake steps and batches (K = 2,
    six calls an epoch, two epochs): each step's scalars, computed at the
    chunk's start from counter_frz_rebone and the silhouette history as
    they stand then, and the order in which the steps' outputs are
    consumed, one chunk behind."""
    from tests.test_torch_trainer import _trainers

    monkeypatch.setattr(JT, "ITERS_PER_EPOCH", 6)
    monkeypatch.setattr(TT, "ITERS_PER_EPOCH", 6)
    jtr, ttr = _trainers(tmp_path, steps_chunk=2, num_epochs=4, loader=None)
    rec = {"jax": {"scal": [], "used": []}, "port": {"scal": [], "used": []}}

    def jstep(*a):
        per_step = a[5]
        K = len(np.asarray(per_step["progress"]))
        rec["jax"]["scal"] += [{f: float(np.asarray(per_step[f])[j]) for f in per_step}
                               for j in range(K)]
        aux, host = _fake_outputs(len(rec["jax"]["scal"]), K)
        return a[0], a[1], aux, host

    def tstep(batch, extras0, per_step, generator=None, draws=None):
        K = per_step["progress"].shape[0]
        rec["port"]["scal"] += [{f: float(per_step[f][j]) for f in per_step} for j in range(K)]
        aux, host = _fake_outputs(len(rec["port"]["scal"]), K)
        return ({k: torch.from_numpy(v) for k, v in aux.items()},
                {k: torch.from_numpy(v) for k, v in host.items()})

    jtr.opt_state = None  # train() makes it; the fake step passes it through
    jtr.get_step_fn = lambda *a, **k: jstep
    ttr.get_step_fn = lambda *a, **k: (tstep, 4, 0)
    for tr, key in ((jtr, "jax"), (ttr, "port")):
        tr.loader = _FakeLoader()
        tr.counter_frz_rebone = 0.01  # as after a bone re-init: lags within a chunk
        consume = tr._consume_step_outputs

        def used(fid, aux, host, epoch, i, consume=consume, key=key, tr=tr):
            rec[key]["used"].append((epoch, i, tuple(np.asarray(fid).tolist()),
                                     float(aux["total_loss"]), tr.total_steps_done))
            consume(fid, aux, host, epoch, i)
        tr._consume_step_outputs = used
    assert jtr.steps_chunk == ttr.steps_chunk == 2
    for epoch in range(2):
        jtr.train_one_epoch(epoch, np.zeros((8, 3), np.float32), 0.0)
        ttr.train_one_epoch(epoch, np.zeros((8, 3), np.float32), 0.0)
    assert len(rec["port"]["scal"]) == 12
    assert rec["port"]["scal"] == rec["jax"]["scal"]
    assert rec["port"]["used"] == rec["jax"]["used"]
    np.testing.assert_array_equal(ttr.latest_vars["sil_err"], jtr.latest_vars["sil_err"])
    assert ttr.total_steps_done == jtr.total_steps_done == 12
    assert ttr.counter_frz_rebone == jtr.counter_frz_rebone
    # the median reached the scalars of later chunks, one chunk behind
    meds = [s["sil_err_median"] for s in rec["port"]["scal"]]
    assert meds[0] == meds[1] == meds[2] == meds[3] == 1e9 and meds[4] < 1e9


def _line_loader(tmp_path, **kw):
    from moda_tpu_torch.data.dataset import PairLoader, build_line_datasets
    from moda_tpu_torch.data.synthetic import SynthScene, write_line_dataset

    if not (tmp_path / "cfg").exists():
        write_line_dataset(str(tmp_path / "db"), str(tmp_path / "cfg"), "syn",
                           SynthScene(img_size=8, num_frames=4))
    ds = build_line_datasets("syn", 8, str(tmp_path / "cfg"))
    return PairLoader(ds, 2, seed=3, npix=4, **kw)


def test_next_chunk_is_k_next_calls_and_leaks_no_thread(tmp_path):
    """next_chunk(k) stacks the batches k calls of next() would return (one
    worker: one batch sequence per seed); changing k starts no thread;
    close() joins every worker; next and next_chunk then raise."""
    before = threading.active_count()
    a = _line_loader(tmp_path, num_threads=1)
    b = _line_loader(tmp_path, num_threads=1)
    assert threading.active_count() == before + 2
    for k in (2, 3, 1, 2):
        stacked, fids = a.next_chunk(k)
        want = [next(b) for _ in range(k)]
        assert threading.active_count() == before + 2
        assert len(fids) == k
        for f in want[0]:
            assert stacked[f].shape[0] == k
            for j in range(k):
                np.testing.assert_array_equal(stacked[f][j], want[j][f], err_msg=f)
        for j in range(k):
            np.testing.assert_array_equal(fids[j], want[j]["frameid"])
    a.close()
    b.close()
    assert threading.active_count() == before
    with pytest.raises(RuntimeError, match="closed"):
        next(a)
    with pytest.raises(RuntimeError, match="closed"):
        a.next_chunk(2)


@pytest.mark.slow
def test_chunked_step_matches_jax():
    """The port's chunked step (K = 2) against moda_tpu's lax.scan chunked
    step in test_chunked_step.py's setting, with the JAX keys' draws:
    losses, the schedule's lr per step, group norms and parameters.
    Tolerances from moda_tpu against itself, its parameters moved by 1e-6
    relative Gaussian noise (five draws; the scale of the frameworks' fp32
    rounding): the first step's loss moved up to 1.3e-5 (held at 1e-4),
    its group norms up to 6.8e-3, bones_g up to 2.3% (held at 1e-2 and
    5e-2: this setting's first key sends a point near the camera plane,
    where the skinning gradients are ill-conditioned in both packages;
    test_torch_step.py picks another key for that reason), and the second
    step's loss up to 1.6e-3 (held at 5e-3): it starts from parameters
    that Adam's first step (~lr x sign(g)) may have moved apart where a
    gradient is within rounding of 0, so its group norms are not compared
    (ROADMAP §3); the schedule's lr is. Parameters at Adam's bound, two
    sign flips x the group LR multiplier (10 at most) x each step's lr
    (lr0, then 25 lr0 at these total_steps; moda_tpu against itself read
    52 lr0): that check catches only non-finite or runaway updates. A
    dropped, repeated or mis-sliced step moves the losses by O(1) (4.86 and
    0.28 here); the chunk against the port's own sequential steps is held
    bit for bit by
    test_chunked_step_is_k_sequential_steps."""
    import __graft_entry__ as G
    from moda_tpu.train.optim import MoDAOptimizer as JOpt
    from moda_tpu_torch import bridge
    from moda_tpu_torch.config import DataInfo as TInfo
    from moda_tpu_torch.config import MoDAConfig as TConfig
    from moda_tpu_torch.fields.model import MoDAModel as TModel
    from moda_tpu_torch.train.optim import MoDAOptimizer as TOpt
    from tests.torch_parity import jax_draws

    K = 2
    cfg, model, params, mvars = G._tiny_setup()
    kw = dict(nsample=2, ndepth=cfg.ndepth, use_fine=False, use_dskin=True, use_bones=True)
    jstep = JS.make_train_step(model, JOpt(cfg, total_steps=100), **kw, donate=False,
                               chunk_steps=K)
    batches = [G._tiny_batch(cfg, n_pairs=2, seed=s) for s in (0, 1)]
    keys = [jax.random.key(5), jax.random.key(6)]
    progs = [0.4, 0.5]

    def extras(mod, pr, arr):
        return mod.StepExtras(progress=arr(pr), loss_select=arr(1), root_update=arr(1.0),
                              body_update=arr(1.0), shape_update=arr(0.0), cvf_update=arr(0.0),
                              sil_err_median=arr(1e9), shape_samp=arr(np.zeros((64, 3), np.float32)),
                              shape_samp_valid=arr(0.0), embed_alpha=arr(10.0))

    jopt = JOpt(cfg, total_steps=100)
    per_step = {f: jnp.stack([getattr(extras(JS, p, jnp.asarray), f) for p in progs])
                for f in JS.CHUNK_STEP_FIELDS}
    stacked = {k: jnp.stack([b[k] for b in batches]) for k in batches[0]}
    jp, _, jaux, _ = jstep(params, jopt.init(params), mvars, stacked,
                           extras(JS, 0.0, jnp.asarray), per_step, jnp.stack(keys))

    tcfg = TConfig.from_json(cfg.to_json())
    tmodel = TModel(tcfg, TInfo(offset=(0, 8), intrinsics=((40.0, 40.0, 16.0, 16.0),)),
                    device="cpu")
    bridge.load_params(tmodel, params)
    bridge.load_mvars(tmodel, mvars)
    tstep = TS.make_train_step(tmodel, TOpt(tcfg, total_steps=100), **kw, device="cpu",
                               chunk_steps=K)
    nb = [{k: np.asarray(v) for k, v in b.items()} for b in batches]
    tb = {k: torch.from_numpy(np.stack([b[k] for b in nb])) for k in nb[0]}
    tb = {k: v.long() if v.dtype == torch.int32 else v for k, v in tb.items()}
    tper = {f: torch.tensor([float(np.asarray(per_step[f])[j]) for j in range(K)])
            for f in TS.CHUNK_STEP_FIELDS}
    taux, _ = tstep(tb, extras(TS, 0.0, torch.tensor), tper,
                    draws=[jax_draws(k, cfg, b, 2) for k, b in zip(keys, nb)])
    for j, rtol in enumerate((1e-4, 5e-3)):
        np.testing.assert_allclose(float(taux["total_loss"][j]),
                                   float(np.asarray(jaux["total_loss"])[j]), rtol=rtol)
    np.testing.assert_allclose(taux["lr"].numpy(), np.asarray(jaux["lr"]), rtol=1e-6)
    for k in ("nerf_coarse_g", "nerf_feat_g", "nerf_skin_g", "nerf_root_rts_g", "pose_code_g",
              "nerf_body_rts_g", "bones_g"):
        np.testing.assert_allclose(float(taux[k][0]), float(np.asarray(jaux[k])[0]),
                                   rtol=5e-2 if k == "bones_g" else 1e-2, err_msg=k)
    jflat = bridge.flatten(jax.tree_util.tree_map(np.asarray, jp))
    for n, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jflat[n.replace(".", "/")],
                                   atol=20 * float(taux["lr"].sum()), rtol=0, err_msg=n)
