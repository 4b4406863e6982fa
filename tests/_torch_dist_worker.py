"""One rank of a 2-process gloo run of the port (spawned by the
test_torch_sharding, test_torch_multihost, test_torch_determinism and
test_torch_shard_share files through :func:`spawn`; the 'mesh22' mode
runs four, and tests/test_torch_cuda.py's 'graph' mode runs two on the
card).

Each rank calls nestmc_torch.parallel.multihost.initialize(device="cpu")
with the NESTMC_* env (a ``file://`` rendezvous in the test's tmp dir, so
parallel test workers never race for a port), runs every case of its mode
on the CPU with one torch thread, and writes ``rank<r>.npz`` (arrays) and
``rank<r>.json`` (scalars) into the tmp dir. Inputs the test made come in
``in.npz`` there. ``spawn(..., device="cuda")`` puts the ranks on the
card instead (two ranks share it: gloo).
"""

import json
import os
import subprocess
import sys

import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(mode: str, tmp, timeout: float = 120.0, nproc: int = 2,
          device: str = "cpu"):
    """Run ``mode`` on ``nproc`` ranks; returns [(arrays, scalars)] by rank.
    Every rank has ``timeout`` seconds: a hung rendezvous fails the test
    instead of the whole run."""
    tmp = str(tmp)
    procs = []
    # stderr to files: a full pipe would stall a rank, and every other
    # rank in its next collective
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
            for r in range(nproc)]
    for rank in range(nproc):
        env = {
            **os.environ,
            "NESTMC_COORDINATOR_ADDRESS": f"file://{tmp}/rendezvous",
            "NESTMC_NUM_PROCESSES": str(nproc),
            "NESTMC_PROCESS_ID": str(rank),
            "NESTMC_WORKER_DIR": tmp,
            "NESTMC_WORKER_MODE": mode,
            "NESTMC_WORKER_DEVICE": device,
            "OMP_NUM_THREADS": "1",
        }
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env, cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=logs[rank]))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"{mode}: a rank ran past {timeout} s")
    finally:
        for f in logs:
            f.close()
    for rank, p in enumerate(procs):
        with open(os.path.join(tmp, f"rank{rank}.log")) as f:
            err = f.read()
        assert p.returncode == 0, f"{mode} rank failed:\n{err[-3000:]}"
    out = []
    for rank in range(nproc):
        with np.load(os.path.join(tmp, f"rank{rank}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            out.append((arrays, json.load(f)))
    return out


# ---- the cases (run in the spawned ranks) ------------------------------

def _cfg(chains, warmup, draws, cs=1, gs=1, **run):
    from nestmc_torch import RunConfig, SamplerConfig, ShardingConfig

    return SamplerConfig(
        run=RunConfig(chains=chains, warmup=warmup, draws=draws,
                      log_every_segment=False, **run),
        sharding=ShardingConfig(chain_shards=cs, group_shards=gs))


def _np(t):
    return t.detach().cpu().numpy()


def mode_sharding(inp, arrays, scalars):
    import torch

    from nestmc_torch import sample
    from nestmc_torch.data import from_numpy, from_numpy_ragged
    from nestmc_torch.kernels.state import init_kernel_state
    from nestmc_torch.models import (
        make_hier_logistic,
        make_nested_poisson,
        synth_logistic,
        synth_poisson3,
    )
    from nestmc_torch.parallel import (
        data_shardings,
        gather_state,
        make_mesh,
        shard_inputs,
        state_shardings,
    )
    from nestmc_torch.parallel.collectives import (
        activate,
        gather,
        groups_sum,
    )
    from nestmc_torch.parallel.sharding import make_shard
    from nestmc_torch.rng import SweepRNG

    # the population conditionals and the joint on group-sharded state
    data = from_numpy(inp["x"], inp["y"], inp["mask"], device="cpu")
    model = make_hier_logistic(data)
    cfg = _cfg(16, 0, 0, gs=2)
    mesh = make_mesh(cfg)
    full = init_kernel_state(
        model, cfg, SweepRNG(0, "cpu"), data,
        position={k: torch.from_numpy(inp[k]) for k in
                  ("beta", "mu", "log_tau")})
    sstate, sdata = shard_inputs(full, data, model, cfg, mesh)
    with activate(make_shard(model, data, cfg, mesh)):
        pos = sstate.position
        arrays["cond_mu"] = _np(model.cond_logdensity("mu", pos["mu"], pos,
                                                      sdata))
        arrays["cond_log_tau"] = _np(model.cond_logdensity(
            "log_tau", pos["log_tau"], pos, sdata))
        arrays["joint"] = _np(model.joint_logdensity(pos, sdata))
        arrays["beta_local"] = _np(pos["beta"])
        # placement: specs and the rank's shapes
        sh = state_shardings(model, cfg, mesh)
        scalars["spec_beta"] = list(sh.position["beta"])
        scalars["spec_mu"] = list(sh.position["mu"])
        scalars["spec_x"] = list(data_shardings(data, cfg, mesh)["x"])
        scalars["beta_shape"] = list(pos["beta"].shape)
        scalars["mu_shape"] = list(pos["mu"].shape)
        scalars["x_shape"] = list(sdata.x.shape)
        scalars["cache_shape"] = list(sstate.cache["beta"].shape)
        # groups_sum over the two ranks against the plain sum
        g = torch.Generator().manual_seed(3)
        whole = torch.randn(4, 10, 3, generator=g)
        half = whole[:, 5 * mesh.group_index:5 * mesh.group_index + 5]
        arrays["groups_sum"] = _np(groups_sum(half, 1))
        arrays["plain_sum"] = _np(whole.sum(dim=1))
        arrays["gathered_beta"] = _np(gather(pos["beta"], ("chains",
                                                          "groups")))

    # two sweeps of every group-sharded model and algorithm
    from nestmc_torch.parallel.collectives import gather
    from nestmc_torch.parallel.sharding import map_specs

    for name, m, d, alg in sweep_cases():
        cfg = _cfg(6, 0, 0, gs=2)
        shard = make_shard(m, d, cfg, mesh)
        st, rng = sweep_pair(m, d, alg, shard, with_rng=True)
        specs = state_shardings(m, cfg, mesh)
        full = map_specs(lambda t, sp: gather(t, sp, shard), specs, st)
        for k, v in full.position.items():
            arrays[f"sweep_{name}_{k}"] = _np(v)
        for k, v in full.accept_sum.items():
            arrays[f"sweep_{name}_accept_{k}"] = _np(v)
        for k, v in rng.get_state().items():
            arrays[f"sweep_{name}_rng_{k}"] = _np(v)

    # the three-level model, groups and subjects split over the ranks
    d3, _ = synth_poisson3(6, G=8, subjects_per_group=4, n=6, p=2,
                           device="cpu")
    post = sample(make_nested_poisson(d3), d3, _cfg(
        8, 30, 30, gs=2, collect={"mu": None, "log_tau_g": None,
                                  "beta_s": 3}))
    arrays["np_mu"] = _np(post.draws["mu"])
    arrays["np_beta_s"] = _np(post.draws["beta_s"])
    scalars["np_final_beta_s"] = list(gather_state(post).position[
        "beta_s"].shape)

    # ragged data: a chain-sharded run
    rd, _ = synth_logistic(7, G=40, n=12, p=2, ragged=True, device="cpu")
    rmodel = make_hier_logistic(rd)
    post = sample(rmodel, rd, _cfg(16, 30, 30, cs=2, collect={"mu": None}))
    arrays["ragged_mu"] = _np(post.draws["mu"])

    # ragged data group-sharded: the population conditionals and the
    # joint on each route, and a short run that collects picked groups
    x, y, seg, G = ragged_case()
    rd = from_numpy_ragged(x, y, seg, G, device="cpu")
    cfg = _cfg(16, 0, 0, gs=2)
    for impl in ("bucket", "pallas-segment"):
        m = make_hier_logistic(rd, loglik_impl=impl)
        full = init_kernel_state(
            m, cfg, SweepRNG(0, "cpu"), rd,
            position={k: torch.from_numpy(inp["r_" + k]) for k in
                      ("beta", "mu", "log_tau")})
        sstate, sdata = shard_inputs(full, rd, m, cfg, mesh)
        with activate(make_shard(m, rd, cfg, mesh)):
            pos = sstate.position
            arrays[f"ragged_{impl}_cond_mu"] = _np(m.cond_logdensity(
                "mu", pos["mu"], pos, sdata))
            arrays[f"ragged_{impl}_cond_log_tau"] = _np(m.cond_logdensity(
                "log_tau", pos["log_tau"], pos, sdata))
            arrays[f"ragged_{impl}_joint"] = _np(m.joint_logdensity(pos,
                                                                    sdata))
            arrays[f"ragged_{impl}_group_loglik"] = _np(gather(
                m.derived["group_loglik"](pos), ("chains", "groups")))
        scalars[f"ragged_{impl}_obs_span"] = list(make_shard(
            m, rd, cfg, mesh).spans["obs"])
    post = sample(make_hier_logistic(rd), rd, _cfg(
        8, 10, 12, gs=2, collect={"mu": None, "beta": [1, 38, 25, 3],
                                  "group_loglik": 30}))
    for k, v in post.draws.items():
        arrays[f"ragged_run_{k}"] = _np(v)
    arrays["ragged_run_final_beta"] = _np(
        gather_state(post).position["beta"])

    # each rank's setup carry against the cut of the global one
    for split, cs, gs in (("groups", 1, 2), ("chains", 2, 1)):
        for name, m, d, alg, precond in setup_cases():
            scalars[f"setup_{split}_{name}"] = setup_check(m, d, alg, precond,
                                                           cs, gs)
    # the allocation audit and the finalized maps, on both splits
    for split, cs, gs in (("groups", 1, 2), ("chains", 2, 1)):
        for name, m, d, alg in run_cases():
            scalars[f"audit_{split}_{name}"] = audit_run(m, d, alg, cs, gs)
    for name, m, d, alg in run_cases():
        rhat_pair(m, d, alg, 1, 2, f"rhat_groups_{name}", arrays)


AUDIT_C = 12       # the audit's chains: no other extent of its runs


def setup_cases():
    """(name, model, data, algorithm, precond) of the per-shard setup
    checks: every sweep case, and two with a preconditioner."""
    out = [c + ("none",) for c in sweep_cases()]
    byname = {c[0]: c for c in sweep_cases()}
    for name, precond in (("logistic_rwmh", "diag"),
                          ("logistic_mala", "full")):
        _, m, d, alg = byname[name]
        out.append((f"{name}_{precond}", m, d, alg, precond))
    return out


def _kcfg(alg, chains, warmup, draws, cs, gs, precond="none", **run):
    from nestmc_torch import KernelConfig, SamplerConfig

    cfg = _cfg(chains, warmup, draws, cs, gs, **run)
    return SamplerConfig(kernel=KernelConfig(algorithm=alg, precond=precond),
                         run=cfg.run, sharding=cfg.sharding)


def _leaves(tree, prefix=""):
    """[(path, tensor)] of a KernelState's or a nested dict's tensors."""
    import dataclasses

    import torch

    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if torch.is_tensor(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaves(tree[k], f"{prefix}.{k}")]
    return []


def setup_check(model, data, alg, precond, cs, gs):
    """{'leaves': n, 'differ': [...]}: this rank's shard_state against
    the cut of the global init_kernel_state from the same seed, leaf by
    leaf, bitwise (shapes included)."""
    import torch

    from nestmc_torch.kernels.state import init_kernel_state
    from nestmc_torch.parallel.sharding import (
        make_mesh,
        make_shard,
        map_specs,
        shard_state,
        state_shardings,
        take,
    )
    from nestmc_torch.rng import SweepRNG

    cfg = _kcfg(alg, 6, 0, 0, cs, gs, precond)
    mesh = make_mesh(cfg)
    shard = make_shard(model, data, cfg, mesh)
    ref = map_specs(lambda t, sp: take(t, sp, shard.spans),
                    state_shardings(model, cfg, mesh),
                    init_kernel_state(model, cfg, SweepRNG(1, "cpu"), data))
    got = shard_state(model, cfg, SweepRNG(1, "cpu"), shard)
    a, b = dict(_leaves(got)), dict(_leaves(ref))
    differ = sorted(set(a) ^ set(b)) + [
        k for k in sorted(set(a) & set(b))
        if a[k].shape != b[k].shape or not torch.equal(a[k], b[k])]
    return {"leaves": len(b), "differ": differ}


def run_cases():
    """(name, model, data, algorithm) of the audited and R-hat runs: the
    padded hier_logistic on each algorithm, nested_poisson and config 4's
    two ragged routes, at AUDIT_C chains and unit extents that no part
    of them, nor a slice of a part, shares (20 groups; 40 subjects of 8
    groups; 40 ragged groups)."""
    from nestmc_torch.data import from_numpy_ragged
    from nestmc_torch.models import (
        make_hier_logistic,
        make_nested_poisson,
        synth_logistic,
        synth_poisson3,
    )

    d2, _ = synth_logistic(4, G=20, n=8, p=3, device="cpu")
    d3, _ = synth_poisson3(4, G=8, subjects_per_group=5, n=6, p=2,
                           device="cpu")
    rd = from_numpy_ragged(*ragged_case(), device="cpu")
    out = [(f"logistic_{alg}", make_hier_logistic(d2), d2, alg)
           for alg in ("newton", "mala", "rwmh")]
    out.append(("poisson3_newton", make_nested_poisson(d3), d3, "newton"))
    out.append(("ragged_bucket_newton",
                make_hier_logistic(rd, loglik_impl="bucket"), rd, "newton"))
    out.append(("ragged_segment_mala",
                make_hier_logistic(rd, loglik_impl="pallas-segment"), rd,
                "mala"))
    return out


def _unit_extents(data):
    from nestmc_torch.data import NestedData3

    if isinstance(data, NestedData3):
        return (data.num_groups, data.num_subjects)
    return (data.num_groups,)


def audit_run(model, data, alg, cs, gs):
    """A short full_rhat run under :class:`_Audit`: the tensors this rank
    allocated, outside SweepRNG's draws and the model's position draw,
    with both the global chain extent and a global unit extent, from
    sample()'s entry to the window's end: the final gathers
    (engine._gather_out) when the groups are split, the finalize
    (engine._finalize) when only the chains are."""
    import dataclasses

    from nestmc_torch import engine, sample
    from nestmc_torch.rng import SweepRNG

    audit = _Audit(AUDIT_C, _unit_extents(data))
    model = dataclasses.replace(model,
                                init_state=audit.outside(model.init_state))
    end = "_gather_out" if gs > 1 else "_finalize"
    saved = {"end": getattr(engine, end), "rng": SweepRNG._sharded}
    setattr(engine, end, audit.ends(saved["end"]))
    SweepRNG._sharded = audit.outside(saved["rng"])
    try:
        with audit:
            sample(model, data, _kcfg(alg, AUDIT_C, 4, 6, cs, gs,
                                      full_rhat=True, segment_size=3))
    finally:
        setattr(engine, end, saved["end"])
        SweepRNG._sharded = saved["rng"]
    return {"ops": audit.ops, "global": audit.hits[:10],
            "n_global": len(audit.hits), "ended": not audit.on}


class _Audit(TorchDispatchMode):
    """Records every op output (no views) whose shape holds both the
    global chain extent and one of the global unit extents, while on and
    not inside a call wrapped by :meth:`outside`."""

    def __init__(self, chains, units):
        super().__init__()
        self.chains, self.units = chains, units
        self.on, self.depth, self.ops, self.hits = True, 0, 0, []

    def outside(self, fn):
        def wrapped(*a, **kw):
            self.depth += 1
            try:
                return fn(*a, **kw)
            finally:
                self.depth -= 1
        return wrapped

    def ends(self, fn):
        def wrapped(*a, **kw):
            self.on = False
            return fn(*a, **kw)
        return wrapped

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        import torch
        from torch.utils._pytree import tree_flatten

        out = func(*args, **(kwargs or {}))
        if self.on and not self.depth and not func.is_view:
            self.ops += 1
            for t in tree_flatten(out)[0]:
                if (torch.is_tensor(t) and self.chains in t.shape
                        and any(u in t.shape for u in self.units)):
                    self.hits.append(f"{func} {tuple(t.shape)}")
        return out


def rhat_pair(model, data, alg, cs, gs, tag, arrays):
    """A sharded full_rhat run's maps (``tag``.rhat.<block>,
    ``tag``.ess.<block>.<key>) and, under ``tag``.ref, the maps of its
    accumulators gathered to the global layout first and finalized as one
    device would (the way before the finalize moved to the shards)."""
    from nestmc_torch import engine, sample
    from nestmc_torch.parallel.collectives import gather

    refs = {}
    finalize = engine._finalize

    def spy(acc, shard, specs):
        whole = engine._map_acc(lambda t, sp: gather(t, sp, shard), acc,
                                specs.position)
        refs["maps"] = engine._finalize_maps(*whole)
        return finalize(acc, shard, specs)

    engine._finalize = spy
    try:
        post = sample(model, data, _kcfg(alg, AUDIT_C, 4, 6, cs, gs,
                                         full_rhat=True, segment_size=3))
    finally:
        engine._finalize = finalize
    for pre, (rhat, ess) in ((tag, (post.full_rhat, post.full_ess)),
                             (f"{tag}.ref", refs["maps"])):
        for k, v in rhat.items():
            arrays[f"{pre}.rhat.{k}"] = _np(v)
        for k, e in ess.items():
            for q, v in e.items():
                arrays[f"{pre}.ess.{k}.{q}"] = _np(v)


def ragged_case():
    """(x, y, segment_ids, G) of a small ragged data set whose bucket
    layout puts groups of one bucket on both of two group shards and
    leaves the other bucket empty on the first: groups 0..33 of 1 or 2
    observations (a bucket of cap 2; buckets of fewer than 32 groups
    would merge into the next), then 6 of 3..8 (one of cap 8, all on the
    second shard)."""
    r = np.random.default_rng(11)
    sizes = np.concatenate([r.integers(1, 3, 34), r.integers(3, 9, 6)])
    G, N, p = len(sizes), int(sizes.sum()), 2
    x = r.standard_normal((N, p)).astype(np.float32)
    x[:, 0] = 1.0
    y = (r.random(N) < 0.5).astype(np.float32)
    return x, y, np.repeat(np.arange(G), sizes), G


def sweep_cases():
    """(name, model, data, algorithm) of the one-sweep group-sharding
    checks: every model that declares unit axes, every algorithm."""
    from nestmc_torch.data import NestedData, from_numpy_ragged
    from nestmc_torch.model import vmap_chains
    from nestmc_torch.models import (
        make_eight_schools,
        make_hier_glm,
        make_hier_logistic,
        make_hier_normal_known_scales,
        make_nested_poisson,
        synth_glm,
        synth_hier_normal,
        synth_logistic,
        synth_poisson3,
    )
    from tests._torch_user_model import hier_lists, hier_model, with_init

    out = []
    d2, _ = synth_logistic(4, G=12, n=10, p=3, device="cpu")
    d3, _ = synth_poisson3(4, G=6, subjects_per_group=3, n=8, p=2,
                           device="cpu")
    for alg in ("rwmh", "mala", "newton"):
        out.append((f"logistic_{alg}", make_hier_logistic(d2), d2, alg))
        out.append((f"logistic_ig_{alg}", make_hier_logistic(
            d2, tau_prior="invgamma"), d2, alg))
        out.append((f"poisson3_{alg}", make_nested_poisson(d3), d3, alg))
    for fam, alg in (("poisson", "newton"), ("gaussian", "mala"),
                     ("binomial", "newton"), ("negbin", "rwmh")):
        dg, _ = synth_glm(2, fam, G=11, n=8, p=2, device="cpu")  # 5 + 6
        out.append((f"glm_{fam}_{alg}", make_hier_glm(dg, family=fam), dg,
                    alg))
    rd = from_numpy_ragged(*ragged_case(), device="cpu")
    for impl, algs in (("bucket", ("rwmh", "mala", "newton")),
                       ("pallas-segment", ("rwmh", "mala"))):
        for alg in algs:
            out.append((f"ragged_{impl.split('-')[-1]}_{alg}",
                        make_hier_logistic(rd, loglik_impl=impl), rd, alg))
    es_model, es = make_eight_schools(device="cpu")
    out.append(("eight_schools_rwmh", es_model, es, "rwmh"))
    out.append(("eight_schools_mala", es_model, es, "mala"))
    out.append(("eight_schools_centered_rwmh",
                make_eight_schools(es, centered=True)[0], es, "rwmh"))
    dc = synth_hier_normal(3, G=10, n=5, device="cpu")
    for alg in ("rwmh", "mala"):
        out.append((f"conjugate_{alg}", make_hier_normal_known_scales(dc),
                    dc, alg))
    du = NestedData.from_ragged(*hier_lists(), device="cpu")
    user = vmap_chains(with_init(hier_model("torch")))
    for alg in ("rwmh", "mala"):
        out.append((f"user_vmap_{alg}", user, du, alg))
    return out


def sweep_pair(model, data, alg, shard=None, with_rng=False):
    """Two sweeps (a warmup one, then a sampling one) from the seeded
    carry; with ``shard``, on its part of the carry, data and noise.
    with_rng: return (state, the SweepRNG after the sweeps)."""
    from nestmc_torch import KernelConfig, SamplerConfig
    from nestmc_torch.kernels.gibbs import make_sweep
    from nestmc_torch.kernels.state import init_kernel_state
    from nestmc_torch.parallel.collectives import activate
    from nestmc_torch.parallel.sharding import map_specs, state_shardings
    from nestmc_torch.parallel.sharding import take
    from nestmc_torch.rng import SweepRNG

    mesh = None if shard is None else shard.mesh
    cfg = _cfg(6, 0, 0, cs=mesh.chain_shards if mesh else 1,
               gs=mesh.group_shards if mesh else 1)
    cfg = SamplerConfig(kernel=KernelConfig(algorithm=alg), run=cfg.run,
                        sharding=cfg.sharding)
    state = init_kernel_state(model, cfg, SweepRNG(1, "cpu"), data)
    rng = SweepRNG(2, "cpu")
    if shard is not None:
        specs = state_shardings(model, cfg, mesh)
        state = map_specs(lambda t, sp: take(t, sp, shard.spans), specs,
                          state)
        data = shard.local
        c0, cl, C = shard.spans["chains"]
        if cl != C:
            rng.chains = (c0, C)
    with activate(shard):
        sweep = make_sweep(model, cfg)
        state = sweep(sweep(state, data, True, rng), data, False, rng)
    return (state, rng) if with_rng else state


def mode_multihost(inp, arrays, scalars):
    from nestmc_torch import sample
    from nestmc_torch.models import (
        make_eight_schools,
        make_hier_logistic,
        synth_logistic,
    )
    from nestmc_torch.parallel import multihost

    def moments(post, tag):
        for k in ("mu", "log_tau"):
            v = post.draws[k].double()
            scalars[f"{tag}_{k}_mean"] = float(v.mean())
            scalars[f"{tag}_{k}_var"] = float(v.var(unbiased=False))

    model, data = make_eight_schools(device="cpu")
    post = sample(model, data, _cfg(
        8, 40, 80, cs=2, seed=7, segment_size=80,
        collect={"mu": None, "log_tau": None}))
    moments(post, "chains")
    scalars["chains_sweep"] = post.timings["sweep"]
    data, _ = synth_logistic(9, G=64, n=12, p=3, device="cpu")
    post = sample(make_hier_logistic(data), data, _cfg(
        8, 30, 50, gs=2, seed=7, segment_size=50,
        collect={"mu": None, "log_tau": None}))
    moments(post, "groups")
    scalars["groups_sweep"] = post.timings["sweep"]
    # the command line under the same launch: the primary saves the draws
    from nestmc_torch import cli

    scalars["cli_rc"] = cli.main(
        ["run", "--preset", "eight-schools", "--device", "cpu",
         "--scale", "0.05", "--chain-shards", "2", "--quiet",
         "--collect", "mu,log_tau", "--save-draws",
         os.path.join(inp["dir"], "cli.npz")])
    scalars["rank"] = multihost.rank()
    scalars["world_size"] = multihost.world_size()
    scalars["is_primary"] = multihost.is_primary()
    scalars["backend"] = multihost.backend()


def mode_determinism(inp, arrays, scalars):
    from nestmc_torch import sample
    from nestmc_torch.models import make_hier_logistic, synth_logistic

    data, _ = synth_logistic(21, G=16, n=12, p=2, device="cpu")
    model = make_hier_logistic(data)
    for alg in ("rwmh", "newton"):
        cfg = _cfg(16, 60, 60, cs=2, seed=9)
        cfg = cfg.__class__(kernel=cfg.kernel.__class__(algorithm=alg),
                            run=cfg.run, sharding=cfg.sharding)
        post = sample(model, data, cfg)
        for k, v in post.draws.items():
            arrays[f"chains_{alg}_{k}"] = _np(v)
    post = sample(model, data, _cfg(32, 60, 60, gs=2, seed=9))
    for k, v in post.accept_rates.items():
        scalars[f"groups_accept_{k}"] = float(v.mean())
    arrays["groups_mu_mean"] = _np(post.draws["mu"].mean(dim=(0, 1)))
    # a checkpointed chain-sharded run, resumed unsharded by the test
    post = sample(model, data, _cfg(
        16, 40, 60, cs=2, seed=9, segment_size=20, full_rhat=True,
        checkpoint_dir=os.path.join(inp["dir"], "ck"), checkpoint_every=1))
    arrays["ck_mu"] = _np(post.draws["mu"])


def mode_mesh22(inp, arrays, scalars):
    """Four ranks, chains and groups both split (2 x 2): two sweeps of
    three of the sweep cases, gathered."""
    from nestmc_torch.parallel import make_mesh, state_shardings
    from nestmc_torch.parallel.collectives import gather
    from nestmc_torch.parallel.sharding import make_shard, map_specs

    for name, m, d, alg in sweep_cases():
        if name not in MESH22_CASES:
            continue
        cfg = _cfg(6, 0, 0, cs=2, gs=2)
        mesh = make_mesh(cfg)
        shard = make_shard(m, d, cfg, mesh)
        st = sweep_pair(m, d, alg, shard)
        for k in ("mu",):
            arrays[f"local_{name}_{k}"] = _np(st.position[k])
        full = map_specs(lambda t, sp: gather(t, sp, shard),
                         state_shardings(m, cfg, mesh), st)
        for k, v in full.position.items():
            arrays[f"sweep_{name}_{k}"] = _np(v)
    scalars["chain_index"] = mesh.chain_index
    # the allocation audit and the finalized maps on the 2 x 2 mesh
    for name, m, d, alg in run_cases():
        if name in MESH22_RUNS:
            scalars[f"audit_mesh22_{name}"] = audit_run(m, d, alg, 2, 2)
            rhat_pair(m, d, alg, 2, 2, f"rhat_mesh22_{name}", arrays)


SHARE_C = 12       # the share mode's chains: no other extent of its runs
SHARE_G = 14       # its groups


def share_case():
    """(model, data) of the share mode: hier_logistic at SHARE_G groups."""
    from nestmc_torch.models import make_hier_logistic, synth_logistic

    data, _ = synth_logistic(5, G=SHARE_G, n=6, p=3, device="cpu")
    return make_hier_logistic(data), data


def share_cfg(cs, gs, ckdir=None):
    """The share mode's run: newton, 4 warmup sweeps and 9 draws in
    segments of 3, the streamed R-hat, mu collected; with ``ckdir`` a
    checkpoint after every segment."""
    run = {"full_rhat": True, "segment_size": 3, "collect": {"mu": None}}
    if ckdir is not None:
        run.update(checkpoint_dir=ckdir, checkpoint_every=1)
    return _kcfg("newton", SHARE_C, 4, 9, cs, gs, **run)


def mode_share(inp, arrays, scalars):
    """What a rank holds of a sharded run: (i) a chain-sharded run with a
    checkpoint after every segment under :class:`_Audit` (the tensors
    with both the global chain and group extents that the rank made, and
    which of them inside the gather of a checkpoint to the primary), its
    final_state's shapes and the carry gather_state gives back; (ii) the
    final_state shapes of a group-sharded run; (iii) a sampling run from
    the rank part that warmup_then_state returns, against the same run
    from its gathered global carry."""
    import dataclasses

    import torch

    from nestmc_torch import engine, sample
    from nestmc_torch.engine import warmup_then_state
    from nestmc_torch.parallel import gather_state
    from nestmc_torch.parallel.collectives import gather
    from nestmc_torch.parallel.sharding import (
        make_mesh,
        make_shard,
        map_specs,
        state_shardings,
    )
    from nestmc_torch.rng import SweepRNG

    model, data = share_case()
    audit = _Audit(SHARE_C, (SHARE_G,))
    amodel = dataclasses.replace(model,
                                 init_state=audit.outside(model.init_state))
    inner = []
    saved = {"g": engine.gather_to_primary, "rng": SweepRNG._sharded}

    def tagged(*a, **kw):
        n = len(audit.hits)
        try:
            return saved["g"](*a, **kw)
        finally:
            inner.extend(range(n, len(audit.hits)))

    engine.gather_to_primary = tagged
    SweepRNG._sharded = audit.outside(saved["rng"])
    try:
        with audit:
            post = sample(amodel, data, share_cfg(2, 1, inp["dir"] + "/ck"))
    finally:
        engine.gather_to_primary = saved["g"]
        SweepRNG._sharded = saved["rng"]
    scalars["audit"] = {
        "ops": audit.ops, "n_global": len(audit.hits),
        "n_inside": len(inner),
        "outside": [h for i, h in enumerate(audit.hits)
                    if i not in set(inner)][:10]}
    for k, v in post.final_state.position.items():
        scalars[f"chains_final_shape_{k}"] = list(v.shape)
    for k, v in post.accept_rates.items():
        scalars[f"chains_accept_shape_{k}"] = list(v.shape)
        scalars[f"chains_accept_mean_{k}"] = float(post.accept_mean[k])
    for k, v in post.draws.items():
        arrays[f"chains_draws_{k}"] = _np(v)
    for path, t in _leaves(gather_state(post)):
        arrays[f"chains_final{path}"] = _np(t)

    post = sample(model, data, share_cfg(1, 2))
    for k, v in post.final_state.position.items():
        scalars[f"groups_final_shape_{k}"] = list(v.shape)
    for path, t in _leaves(gather_state(post)):
        arrays[f"groups_final{path}"] = _np(t)

    # (iii) warmup_then_state's rank part into sample()
    cfg = share_cfg(2, 1)
    part = warmup_then_state(model, data, cfg)
    mesh = make_mesh(cfg)
    shard = make_shard(model, data, cfg, mesh)
    whole = map_specs(lambda t, sp: gather(t, sp, shard),
                      state_shardings(model, cfg, mesh), part)
    for tag, init in (("part", part), ("whole", whole)):
        post = sample(model, data, cfg, rng=SweepRNG(3, "cpu"),
                      init_state=init, skip_warmup=True)
        arrays[f"resume_{tag}_mu"] = _np(post.draws["mu"])
    scalars["part_beta_shape"] = list(part.position["beta"].shape)


GRAPH_ALGS = ("newton", "mala", "rwmh")


def mode_graph(inp, arrays, scalars):
    """On the card (two ranks share it: gloo): for each of GRAPH_ALGS, a
    chain-sharded run of a small hier_logistic model replayed from its
    captured steps and the same run stepped eagerly (sample's _eager),
    from one seed: the rank's final part, draws, R-hat maps, both
    generators' states, launches and groups_sum calls of each; then a
    group-sharded run's loop (eager: gloo's collectives go through the
    host)."""
    import torch

    from nestmc_torch import sample
    from nestmc_torch.models import make_hier_logistic, synth_logistic
    from nestmc_torch.ops.cuda import launch_counts, reset_launch_counts
    from nestmc_torch.parallel import collectives, multihost
    from nestmc_torch.rng import SweepRNG

    dev = multihost.device()
    data, _ = synth_logistic(21, G=40, n=12, p=3, device=dev)
    model = make_hier_logistic(data, tau_prior="invgamma")
    for alg in GRAPH_ALGS:
        for tag, eager in (("graph", False), ("eager", True)):
            cfg = _kcfg(alg, 64, 30, 20, 2, 1, seed=7, segment_size=7,
                        full_rhat=True)
            rng = SweepRNG(7, dev)
            reset_launch_counts()
            collectives.STATS["groups_sum_calls"] = 0
            post = sample(model, data, cfg, rng=rng, _eager=eager)
            key = f"{alg}_{tag}"
            scalars[f"{key}_sweep"] = post.timings["sweep"]
            scalars[f"{key}_launches"] = launch_counts()
            scalars[f"{key}_groups_sum_calls"] = (
                collectives.STATS["groups_sum_calls"])
            for k, v in post.draws.items():
                arrays[f"{key}.draws.{k}"] = _np(v)
            for k, v in post.full_rhat.items():
                arrays[f"{key}.rhat.{k}"] = _np(v)
            for path, t in _leaves(post.final_state):
                arrays[f"{key}.final{path}"] = _np(t)
            for k, v in rng.get_state().items():
                arrays[f"{key}.rng.{k}"] = _np(v)
            torch.cuda.synchronize(dev)
    post = sample(model, data, _cfg(64, 4, 4, gs=2, seed=7))
    scalars["groups_sweep"] = post.timings["sweep"]


MESH22_CASES = ("logistic_newton", "poisson3_mala", "glm_gaussian_mala")
MESH22_RUNS = ("logistic_newton", "poisson3_newton", "ragged_bucket_newton")
MODES = {"sharding": mode_sharding, "multihost": mode_multihost,
         "determinism": mode_determinism, "mesh22": mode_mesh22,
         "share": mode_share, "graph": mode_graph}


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from nestmc_torch.parallel import multihost

    device = os.environ.get("NESTMC_WORKER_DEVICE", "cpu")
    multihost.initialize(device=None if device == "cuda" else device)
    tmp = os.environ["NESTMC_WORKER_DIR"]
    path = os.path.join(tmp, "in.npz")
    inp = {"dir": tmp}
    if os.path.exists(path):
        with np.load(path) as z:
            inp.update({k: z[k] for k in z.files})
    arrays, scalars = {}, {}
    MODES[os.environ["NESTMC_WORKER_MODE"]](inp, arrays, scalars)
    rank = multihost.rank()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(scalars, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
