"""Population sharding (A10) across processes: worlds of 2 and 4 ranks on the
CPU (gloo, each world started through a ``FileStore`` in a temporary
directory, so concurrent test workers never meet on a port).

One 4-rank world (the module fixture ``world4``: this file run as a
program, one process a rank) makes every check below and writes each
rank's results; each check is its own test case. Beside it:
``python -m pmfm_tpu_torch.multiprocess_check`` at 2 and 4 ranks (1-D) and
at 4 ranks (2 pop x 2 frame), with the bytes each collective moves, and the
CLI under ``python -m torch.distributed.run --nproc-per-node 2 ... --mesh
2``. The reference's counterparts run in this process on 4 of conftest's 8
virtual devices.
"""
import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 600
RANKS = 4
EVOLVE_FACTOR = 4.0  # tests/test_torch_es.py's rule for whole runs
UNFUSED_LIMITS = (1e-3, 1e-6)  # max / median relative, the unfused engines'
SEEDS = range(4)
GENS = 40
TRUTH = (3078.0, 2.0, 3015.0, 1.5)
# the whole runs' configuration (tests/test_torch_es.py's slice at 4 ranks of 16)
WHOLE = dict(num_parents=4, num_offspring=60, num_dimensions=4, topology="fm2",
             param_mins=(0.0,) * 4, param_maxs=(3520.0, 8.0) * 2, audio_length_log2=8,
             synthesis_engine="scanless", dft_dtype="int8", sine_order=7, fused_kernel=True,
             fused_generation=True, pop_block=8)
# the frame axis (tests/test_parallel.py's TestFrameSharded, scanless synthesis)
FRAMES = dict(num_parents=8, num_offspring=24, num_dimensions=4, topology="fm2",
              param_mins=(0.0,) * 4, param_maxs=(3520.0, 8.0, 3520.0, 1.0), audio_length_log2=8,
              synthesis_engine="scanless", num_frames=4)
PSUM_VALUES_SEED = 11


def _env():
    """The children's environment: the checkout on the path, one thread a
    rank (as ``torch.distributed.run`` sets it)."""
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


# ---- one rank of the 4-rank world (this file run as a program) ------------------------


def _rank_main(rank: int, world: int, store: str, out: str) -> int:
    import torch.distributed as dist

    from pmfm_tpu_torch.es import ESConfig, evolve_checkpointed, init_state, make_spectrum_ops
    from pmfm_tpu_torch.es import match_audio, match_audio_stft, match_many
    from pmfm_tpu_torch.multiprocess_check import digest
    from pmfm_tpu_torch.ops import synthesize_single, target_spectrum
    from pmfm_tpu_torch.ops.spectral import target_spectrum_frames
    from pmfm_tpu_torch.parallel import FRAME_AXIS, POP_AXIS, evolve_sharded
    from pmfm_tpu_torch.parallel import initialize_multihost, make_mesh, sharded_generation_step
    from pmfm_tpu_torch.parallel.sharded import _local_cfg, frame_fitness, sharded_engine
    from pmfm_tpu_torch.utils import aot

    initialize_multihost(f"file://{store}", world, rank, device="cpu")
    res, arrays = {}, {}
    mesh = make_mesh((world,), device="cpu")
    mesh_pf = make_mesh((world // 2, 2), (POP_AXIS, FRAME_AXIS), device="cpu")
    mesh_p = make_mesh((world // 2,), device="cpu")  # ranks 0, 1

    cfg = ESConfig(**WHOLE)
    so = make_spectrum_ops(cfg, device="cpu")
    audio = synthesize_single(torch.tensor(TRUTH), cfg.n_samples * 2, cfg.topology)
    t = target_spectrum(audio[:cfg.n_samples], so)

    # whole runs, B2 (the fused path) and B1 (the unfused path's evaluate)
    for engine, c in (("B2", cfg), ("B1", cfg.replace(fused_generation=False))):
        arrays[f"traj_{engine}"] = np.stack([
            evolve_sharded(init_state(s, c, device="cpu"), t, GENS, so, c, mesh,
                           record_trajectory=True)[1].numpy() for s in SEEDS])

    # early stop: every rank stops at the same generation
    _, traj = evolve_sharded(init_state(7, cfg, device="cpu"), t, 30, so, cfg, mesh,
                             record_trajectory=True)
    thr = float(traj[5])
    c = cfg.replace(fitness_threshold=thr)
    final, _ = evolve_sharded(init_state(7, c, device="cpu"), t, 30, so, c, mesh)
    res["early_stop"] = dict(threshold=thr, generation=final.generation,
                             best=float(final.best_fitness), digest=digest(final))

    # a checkpointed run over the mesh, resumed, against one evolve_sharded
    ck = os.path.join(out, "ck")
    c = cfg.replace(restart_patience=3)
    want, want_traj = evolve_sharded(init_state(4, c, device="cpu"), t, 8, so, c, mesh,
                                     record_trajectory=True)
    evolve_checkpointed(init_state(4, c, device="cpu"), t, 4, so, c, ck, every=2, mesh=mesh,
                        record_trajectory=True)
    got, got_traj = evolve_checkpointed(init_state(4, c, device="cpu"), t, 8, so, c, ck,
                                        every=2, mesh=mesh, record_trajectory=True)
    res["resume"] = dict(equal=digest(got) == digest(want) and got.generation == want.generation
                         and got_traj.tobytes() == want_traj.numpy().tobytes(),
                         digest=digest(got), files=sorted(os.listdir(ck)))

    # the matchers over the mesh
    target = audio.numpy()
    c = cfg.replace(refine_generations=2)
    for name, fn in (
        ("match_audio", lambda: [match_audio(target, c, seed=5, num_generations=6,
                                             record_trajectory=True, mesh=mesh, device="cpu")]),
        ("match_audio_stft", lambda: [match_audio_stft(target, c, seed=5, num_generations=6,
                                                       record_trajectory=True, mesh=mesh,
                                                       device="cpu")]),
        ("match_many", lambda: match_many(np.stack([target, target[::-1].copy()]), c, seed=5,
                                          num_generations=6, mesh=mesh, device="cpu")),
    ):
        results = fn()
        res[name] = [dict(fitness=[ch.best_fitness for ch in r.chunks],
                          generations=[ch.generations_run for ch in r.chunks],
                          trajectory=[None if ch.trajectory is None else ch.trajectory.tolist()
                                      for ch in r.chunks],
                          audio=r.output_audio.tobytes().hex()[:64] + str(r.output_audio.size))
                     for r in results]

    # the frame axis: (2 pop x 2 frame) against (2 pop), and the psum
    fc = ESConfig(**FRAMES)
    fso = make_spectrum_ops(fc, device="cpu")
    faudio = synthesize_single(torch.tensor((0.25, 0.25, 0.5, 0.9)) * torch.tensor(
        fc.param_maxs), fc.n_samples * fc.num_frames, fc.topology)
    tframes = target_spectrum_frames(faudio, fso)
    state = init_state(5, fc, device="cpu")
    out_pf = sharded_generation_step(state, tframes, fso, fc, mesh_pf)
    arrays["pf_fitness"], arrays["pf_values"] = (out_pf.parent_fitness.numpy(),
                                                 out_pf.parent_values.numpy())
    if mesh_p.member:
        out_p = sharded_generation_step(state, tframes, fso, fc, mesh_p)
        arrays["p_fitness"], arrays["p_values"] = (out_p.parent_fitness.numpy(),
                                                   out_p.parent_values.numpy())
    lfc = _local_cfg(fc, 2)
    values = torch.from_numpy(np.random.default_rng(PSUM_VALUES_SEED).random(
        (lfc.population_size, 4)).astype(np.float32))
    arrays["psum"] = frame_fitness(values, tframes, fso, lfc, mesh_pf).numpy()
    arrays["psum_target"] = tframes.numpy()

    # the engine each mesh's generation runs
    res["engines"] = dict(pop=sharded_engine(cfg, so, mesh),
                          pop_frame=sharded_engine(fc, fso, mesh_pf))

    # an artifact over the 4 ranks, called twice: its mesh made once
    m = aot.load_matcher(aot.export_matcher(cfg, 4, 2 * cfg.n_samples, platforms=("cpu",),
                                            mesh_devices=world))
    first = m(3, target[:m.target_samples])
    made = m._mesh
    second = m(3, target[:m.target_samples])
    live = match_audio_stft(target[:m.target_samples], cfg, seed=3, num_generations=4,
                            mesh=mesh, device="cpu")
    res["aot"] = dict(equal=all(np.array_equal(first[k], second[k]) for k in first),
                      reused=m._mesh is made and made.shape == {POP_AXIS: world},
                      fitness=float(first["best_fitness"]),
                      live=float(live.chunks[0].best_fitness),
                      digest=first["parent_values"].tobytes().hex()[:32])

    # the ValueErrors, on every rank before any collective
    errors = {}
    for name, step in (
        ("population", lambda: sharded_generation_step(
            init_state(0, cfg.replace(num_offspring=58), device="cpu"), t, so,
            cfg.replace(num_offspring=58), mesh)),
        ("local_mu", lambda: sharded_generation_step(
            init_state(0, cfg.replace(num_parents=20, num_offspring=44), device="cpu"), t, so,
            cfg.replace(num_parents=20, num_offspring=44), mesh)),
        ("frames", lambda: sharded_generation_step(
            init_state(0, fc.replace(num_frames=3), device="cpu"), tframes[:3], fso,
            fc.replace(num_frames=3), mesh_pf)),
        ("mesh", lambda: make_mesh((2 * world,), device="cpu")),
    ):
        try:
            step()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    res["errors"] = errors

    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    mesh.barrier()
    dist.destroy_process_group()
    return 0


# ---- the fixtures ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Run the 4-rank world once; each rank's results as ``(json, npz)``."""
    tmp = str(tmp_path_factory.mktemp("world4"))
    store = os.path.join(tmp, "store")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", str(RANKS),
         "--store", store, "--out", tmp],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]
    try:
        outs = [p.communicate(timeout=WORLD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-6000:]}"
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            res = json.load(f)
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            ranks.append((res, {k: z[k] for k in z.files}))
    return ranks


_CHECKS = {}


def _check(procs, mesh2d):
    """``python -m pmfm_tpu_torch.multiprocess_check`` once a setting."""
    key = (procs, mesh2d)
    if key not in _CHECKS:
        cmd = [sys.executable, "-m", "pmfm_tpu_torch.multiprocess_check", "--procs", str(procs),
               "--platform", "cpu"]
        _CHECKS[key] = subprocess.run(cmd + (["--mesh2d"] if mesh2d else []), env=_env(),
                                      capture_output=True, text=True, timeout=WORLD_TIMEOUT_S)
    return _CHECKS[key]


CHECKS = [(2, False), (4, False), (4, True)]
CHECK_IDS = ["2proc-1d", "4proc-1d", "4proc-2d"]


# ---- multiprocess_check -----------------------------------------------------------------


@pytest.mark.parametrize("procs,mesh2d", CHECKS, ids=CHECK_IDS)
def test_multiprocess_check(procs, mesh2d):
    """Every rank's final state byte-equal (the reference's
    tests/test_multiprocess.py)."""
    out = _check(procs, mesh2d)
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"OK: {procs} processes" in out.stdout and "disagree" not in out.stdout
    assert len(re.findall(r"^MPCHK ", out.stdout, re.M)) == procs
    engine = "xla_stft (frame-sharded)" if mesh2d else "fused_generation"
    assert re.findall(r"^MPENGINE \d+ (.*)$", out.stdout, re.M) == [engine] * procs


def test_multiprocess_check_defaults_to_the_card(monkeypatch):
    """Without ``--platform cpu`` the check asks for the card, and without
    one it raises before any rank starts."""
    from pmfm_tpu_torch import multiprocess_check as mp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(mp.subprocess, "Popen", lambda *a, **k: spawned.append(a))
    for call in (lambda: mp.run(), lambda: mp.main([])):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
    assert spawned == []


@pytest.mark.parametrize("procs,mesh2d", CHECKS, ids=CHECK_IDS)
def test_collective_payload(procs, mesh2d):
    """Per generation, the pop all-gather moves ranks x mu x (2D + 1) x 4
    bytes whatever P is (at P and 4P), and on the 2-D mesh only the frame
    all-reduce of P_local x 4 bytes is beside it: the reference's
    ``TestCollectiveBytes`` numbers, counted around the ``dist`` calls."""
    from pmfm_tpu_torch.multiprocess_check import MU

    out = _check(procs, mesh2d)
    assert out.returncode == 0, out.stdout + out.stderr
    rows = re.findall(r"^MPBYTES (\d+) pop=(\d+) all_gather=(\d+) all_reduce=(\d+)$",
                      out.stdout, re.M)
    assert len(rows) == 2 * procs
    pop_ranks = procs // 2 if mesh2d else procs
    pops = set()
    for _, pop, gathered, reduced in rows:
        pops.add(int(pop))
        assert int(gathered) == pop_ranks * MU * (2 * 6 + 1) * 4
        assert int(reduced) == (int(pop) // pop_ranks * 4 if mesh2d else 0)
    assert len(pops) == 2 and max(pops) == 4 * min(pops)


# ---- the 4-rank world ---------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["B2", "B1"])
def test_whole_runs_match_reference_outcome(world4, engine):
    """4 ranks' whole runs against pmfm_tpu's ``evolve_sharded`` on 4
    virtual devices, by outcome (the two draw from different generators):
    over 4 seeds the median best fitness within a factor of 4 of the
    reference's, both better than their first generation's; every rank's
    trajectories byte-equal."""
    import jax
    import jax.numpy as jnp

    from pmfm_tpu.es import ESConfig as JConfig
    from pmfm_tpu.es import init_state as j_init_state
    from pmfm_tpu.es import make_spectrum_ops as j_make_spectrum_ops
    from pmfm_tpu.ops import synthesize_single as j_synth
    from pmfm_tpu.ops import target_spectrum as j_target
    from pmfm_tpu.parallel import evolve_sharded as j_evolve_sharded
    from pmfm_tpu.parallel import make_mesh as j_make_mesh

    got = world4[0][1][f"traj_{engine}"]
    for _, arrays in world4[1:]:
        assert arrays[f"traj_{engine}"].tobytes() == got.tobytes()
    jc = JConfig(**dict(WHOLE, fused_generation=engine == "B2"))
    jso = j_make_spectrum_ops(jc)
    jt = j_target(j_synth(jnp.asarray(TRUTH), jc.n_samples, jc.topology), jso)
    mesh = j_make_mesh(shape=(RANKS,))

    @jax.jit
    def run(key):
        return j_evolve_sharded(j_init_state(key, jc), jt, GENS, jso, jc, mesh,
                                record_trajectory=True)[1]

    ref = np.stack([np.asarray(run(jax.random.PRNGKey(s))) for s in SEEDS])
    assert got.shape == ref.shape == (len(SEEDS), GENS) and np.isfinite(got).all()
    assert (np.diff(got, axis=1) <= 0).all()  # best-ever is monotone
    ref_med, got_med = np.median(ref[:, -1]), np.median(got[:, -1])
    assert ref_med / EVOLVE_FACTOR <= got_med <= ref_med * EVOLVE_FACTOR, (got_med, ref_med)
    assert got_med < np.median(got[:, 0]) and ref_med < np.median(ref[:, 0])


def test_early_stop_stops_every_rank_together(world4):
    """Under ``fitness_threshold`` every rank stops at the same generation
    (each reads the replicated best-ever; no extra collective), at or before
    the generation the threshold was first reached."""
    stops = [res["early_stop"] for res, _ in world4]
    assert len({(s["generation"], s["digest"]) for s in stops}) == 1
    assert stops[0]["generation"] <= 6 and stops[0]["best"] <= stops[0]["threshold"]


def test_checkpointed_resume_over_four_ranks(world4):
    """``evolve_checkpointed(mesh=)`` to generation 4, then rerun to 8:
    resumed from the first rank's files, bit-equal to one ``evolve_sharded``
    of 8 on every rank."""
    resumes = [res["resume"] for res, _ in world4]
    assert all(r["equal"] for r in resumes)
    assert len({r["digest"] for r in resumes}) == 1
    assert resumes[0]["files"] == ["gen_chunk0.npz"]


@pytest.mark.parametrize("matcher", ["match_audio", "match_audio_stft", "match_many"])
def test_matchers_over_four_ranks(world4, matcher):
    """``match_audio`` (2 chunks, the refine tail), ``match_audio_stft``
    (2 frames) and ``match_many`` (2 targets) over 4 ranks: every rank's
    result byte-equal, finite, the best-ever trajectory monotone."""
    results = [res[matcher] for res, _ in world4]
    assert all(r == results[0] for r in results[1:])
    for r in results[0]:
        assert all(np.isfinite(f) for f in r["fitness"])
        for traj in r["trajectory"]:
            if traj is not None:
                assert len(traj) == 6 and (np.diff(traj) <= 0).all()
    assert len(results[0]) == (2 if matcher == "match_many" else 1)
    if matcher == "match_audio":
        assert len(results[0][0]["fitness"]) == 2


def test_frame_axis_matches_pop_only_sharding(world4):
    """(2 pop x 2 frame) against (2 pop): the same offspring on each pop
    shard, the frame all-reduce rebuilding the same fitness (within the
    unfused engines' limits) and the same parents (the reference's
    ``test_matches_pop_only_sharding``)."""
    pf = [arrays for _, arrays in world4]
    for a in pf[1:]:
        assert a["pf_fitness"].tobytes() == pf[0]["pf_fitness"].tobytes()
    got, want = pf[0]["pf_fitness"], pf[0]["p_fitness"]
    assert pf[1]["p_fitness"].tobytes() == want.tobytes()
    e = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert e.max() <= UNFUSED_LIMITS[0] and np.median(e) <= UNFUSED_LIMITS[1]
    np.testing.assert_allclose(pf[0]["pf_values"], pf[0]["p_values"], rtol=1e-6)


def test_frame_psum_matches_reference_multiframe_fitness(world4):
    """The frame all-reduce of each rank's window against the reference's
    unsharded multi-frame ``evaluate`` on the same values and target,
    within the unfused engines' limits."""
    import jax.numpy as jnp

    from pmfm_tpu.es import ESConfig as JConfig
    from pmfm_tpu.es import make_spectrum_ops as j_make_spectrum_ops
    from pmfm_tpu.es import strategy as jstrategy

    arrays = world4[0][1]
    jc = JConfig(**FRAMES)
    local = jc.population_size // 2
    values = np.random.default_rng(PSUM_VALUES_SEED).random((local, 4)).astype(np.float32)
    want = np.asarray(jstrategy.evaluate(jnp.asarray(values), jnp.asarray(arrays["psum_target"]),
                                         j_make_spectrum_ops(jc), jc))
    got = arrays["psum"]
    for _, a in world4[1:]:
        assert a["psum"].tobytes() == got.tobytes()
    assert got.shape == want.shape == (local,)
    e = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert e.max() <= UNFUSED_LIMITS[0] and np.median(e) <= UNFUSED_LIMITS[1], (e.max(),
                                                                               np.median(e))


def test_sharded_engine_names_what_runs(world4):
    """``sharded_engine``: B2 at a pop shard's population on the 1-D mesh;
    on a frame axis the frame-sharded unfused path, whatever the config
    picks unsharded."""
    for res, _ in world4:
        assert res["engines"] == dict(pop="fused_generation",
                                      pop_frame="xla_stft (frame-sharded)")


def test_aot_matcher_over_four_ranks_makes_its_mesh_once(world4):
    """An artifact of ``mesh_devices`` 4 called twice in a world of 4: the
    same result both times and on every rank, its mesh made on the first
    call and reused, the fitness the live ``match_audio_stft``'s over a
    mesh of the same shape."""
    results = [res["aot"] for res, _ in world4]
    assert all(r == results[0] for r in results[1:])
    assert results[0]["equal"] and results[0]["reused"]
    assert results[0]["fitness"] == results[0]["live"] and np.isfinite(results[0]["fitness"])


@pytest.mark.parametrize("case,match", [
    ("population", "population 62 not divisible by mesh size 4"),
    ("local_mu", "local population 16 smaller than num_parents 20"),
    ("frames", "num_frames 3 not divisible by frame-axis size 2"),
    ("mesh", r"mesh shape \(8,\) needs 8 ranks, the world has 4"),
])
def test_value_errors_on_four_ranks(world4, case, match):
    """The four ``ValueError``s in a world of 4, on every rank."""
    for res, _ in world4:
        assert res["errors"][case] is not None and re.search(match, res["errors"][case])


# ---- the CLI ------------------------------------------------------------------------------


def test_cli_mesh_two_ranks(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    pmfm_tpu_torch.cli -j parameters.json --mesh 2`` on the CPU: a gloo
    world of 2, the engine line naming the mesh, one report and one WAV
    (from the first rank)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "pmfm_tpu_torch.cli", "-j", os.path.join(REPO, "parameters.json"),
           "--platform", "cpu", "--generations", "3", "--mesh", "2"]
    out = subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True, text=True,
                         timeout=WORLD_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "mesh {'pop': 2} on gloo, 16 a rank" in out.stdout
    assert out.stdout.count("chunk 0: fitness = ") == 1
    assert out.stdout.count("Overall best parameters found") == 1
    assert (tmp_path / "output_audio" / "output.wav").exists()


def test_cli_frame_mesh_two_ranks(tmp_path):
    """The CLI on a (1 pop x 2 frame) mesh from the config's
    ``tpu.meshShape``/``meshAxisNames`` under ``torch.distributed.run``,
    ``--mode stft`` over the 2 frames of parameters.json's target at n 1024:
    the engine line names the frame-sharded unfused path that runs (not
    B2), one report and one WAV."""
    run = json.loads(open(os.path.join(REPO, "parameters.json")).read())
    run["tpu"] = {"meshShape": [1, 2], "meshAxisNames": ["pop", "frame"]}
    path = tmp_path / "mesh2d.json"
    path.write_text(json.dumps(run))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "pmfm_tpu_torch.cli", "-j", str(path), "--platform", "cpu",
           "--generations", "3", "--mode", "stft", "--audio-log2", "10"]
    out = subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True, text=True,
                         timeout=WORLD_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert ("engine: xla_stft (frame-sharded) on cpu (stft mode, fm3_series, n=1024, "
            "2 frames a run, pop=32, mesh {'pop': 1, 'frame': 2} on gloo, 32 a rank, "
            "3 generations)") in out.stdout
    assert out.stdout.count("chunk 0: fitness = ") == 1
    assert (tmp_path / "output_audio" / "output.wav").exists()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    sys.exit(_rank_main(a.rank, a.world, a.store, a.out))
