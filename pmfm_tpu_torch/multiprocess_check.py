"""Multi-process check of the sharded matcher (port of
``tools/multiprocess_check.py``).

    python -m pmfm_tpu_torch.multiprocess_check                 # 2 ranks share cuda:0
    python -m pmfm_tpu_torch.multiprocess_check --procs 4
    python -m pmfm_tpu_torch.multiprocess_check --procs 4 --mesh2d  # 2 pop x 2 frame
    python -m pmfm_tpu_torch.multiprocess_check --platform cpu      # gloo ranks on the CPU

The parent spawns N separate processes, each a rank of one
``torch.distributed`` world started through a ``FileStore`` in a temporary
directory (so that concurrent checks never meet on a port): gloo between
ranks that share the first card, or on the CPU. Each rank runs
``parallel.evolve_sharded`` for a few generations with the top-mu
all-gather (and on the 2-D mesh the frame all-reduce) crossing process
boundaries, then prints a digest of its final state; the parent checks
that every rank's state is byte-equal and prints ``OK: N processes``.

Each rank also counts the bytes its collectives move in one generation, at
the check's population and at four times it (``MPBYTES``), by wrapping the
``torch.distributed`` calls, its B2 launches (``MPLAUNCH``), the engine
its generations run (``MPENGINE``: ``parallel.sharded.sharded_engine``)
and its milliseconds a generation (``MPTIME``; ranks that share a card
measure their contention, not scaling). On the 2-D mesh each rank also holds the
frame all-reduce of its window's fitness against the unsharded
multi-frame fitness of the same candidates (``MPFRAME``, max and median
relative error). ``run`` takes another configuration and generation count
from its caller (the card's smoke test passes the bench's shape). On the
card the parent builds the kernel library first; the ranks load it
(``kernels._build.library_path``) and never start ``nvcc``.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import tempfile

CHILD_TIMEOUT_S = 300
GENERATIONS = 3
MU = 4
LOCAL_POP = 16  # candidates a pop shard
TARGET_SEED = 3  # the target: one candidate of this seed, synthesised
FRAME_CHECK_SEED = 17


def config(n_pop_shards: int, frames: int):
    """The check's configuration: fm3_series, n 256, int8 under B2 (the
    fused path) at LOCAL_POP candidates a pop shard; several frames take
    the unfused frame-sharded path."""
    from .es import ESConfig

    return ESConfig(
        num_parents=MU, num_offspring=LOCAL_POP * n_pop_shards - MU, num_dimensions=6,
        topology="fm3_series", audio_length_log2=8, synthesis_engine="scanless",
        dft_dtype="int8", sine_order=7, fused_kernel=True, fused_generation=True,
        pop_block=LOCAL_POP, num_frames=frames,
    )


def _refuse(*_a, **_k):
    raise RuntimeError("a rank of the check must not build the kernels: the parent builds them")


def _counting(dist):
    """Wrap ``dist.all_gather`` and ``dist.all_reduce`` to count the bytes
    each moves (an all-gather's output list, an all-reduce's tensor)."""
    counts = {"all_gather": 0, "all_reduce": 0}
    gather, reduce = dist.all_gather, dist.all_reduce

    def all_gather(out, t, *a, **k):
        counts["all_gather"] += sum(o.numel() * o.element_size() for o in out)
        return gather(out, t, *a, **k)

    def all_reduce(t, *a, **k):
        counts["all_reduce"] += t.numel() * t.element_size()
        return reduce(t, *a, **k)

    dist.all_gather, dist.all_reduce = all_gather, all_reduce
    return counts


def digest(state) -> str:
    """sha256 of a state's tensors, as bytes on the host."""
    h = hashlib.sha256()
    for t in (state.parent_values, state.parent_steps, state.parent_fitness,
              state.best_values, state.best_fitness, state.stall):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def child(rank: int, procs: int, store: str, mesh2d: bool, platform: str, cfg_path: str,
          generations: int) -> int:
    import json
    import time

    import numpy as np
    import torch
    import torch.distributed as dist

    from .es import evaluate, init_state, make_spectrum_ops
    from .kernels import _build, fused_generation
    from .ops import synthesize_single
    from .ops.spectral import target_spectrum_frames
    from .ops.synthesis import scale_params
    from .parallel import FRAME_AXIS, POP_AXIS, evolve_sharded, initialize_multihost, make_mesh
    from .parallel.mesh import local_device
    from .parallel.sharded import _local_cfg, frame_fitness, sharded_engine
    from .utils.aot import config_from_dict

    dev = local_device(platform)
    if dev.type == "cuda":
        if not _build.library_path().exists():
            raise RuntimeError(f"no kernel library at {_build.library_path()}")
        _build.build = _refuse
    initialize_multihost(f"file://{store}", procs, rank, device=dev)
    if mesh2d:
        mesh = make_mesh((procs // 2, 2), (POP_AXIS, FRAME_AXIS), device=dev)
    else:
        mesh = make_mesh((procs,), device=dev)
    frames = mesh.axis_size(FRAME_AXIS)
    with open(cfg_path) as f:
        cfg = config_from_dict(json.load(f))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def target(c, so):
        genes = np.random.default_rng(TARGET_SEED).random(c.num_dimensions).astype(np.float32)
        truth = scale_params(torch.from_numpy(genes), torch.tensor(c.param_mins),
                             torch.tensor(c.param_maxs))
        t = target_spectrum_frames(
            synthesize_single(truth, c.n_samples * c.num_frames, c.topology).to(dev), so)
        return t if c.num_frames > 1 else t[0]

    counts = _counting(dist)
    # the run, then one generation at four times the population (its bytes)
    runs = [(cfg, generations),
            (cfg.replace(num_offspring=4 * cfg.population_size - cfg.num_parents), 1)]
    for i, (c, gens) in enumerate(runs):
        so = make_spectrum_ops(c, device=dev)
        tspec = target(c, so)
        if i == 0:  # a warm-up generation outside the counts and the time
            evolve_sharded(init_state(1, c, device=dev), tspec, 1, so, c, mesh)
            fused_generation.launches = 0
        counts.update(all_gather=0, all_reduce=0)
        sync()
        t0 = time.perf_counter()
        final, _ = evolve_sharded(init_state(0, c, device=dev), tspec, gens, so, c, mesh)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / gens
        per_gen = {k: v // gens for k, v in counts.items()}
        print(f"MPBYTES {rank} pop={c.population_size} all_gather={per_gen['all_gather']} "
              f"all_reduce={per_gen['all_reduce']}", flush=True)
        if i == 0:
            print(f"MPCHK {rank} best={float(final.best_fitness):.9e} "
                  f"generation={final.generation} digest={digest(final)}", flush=True)
            print(f"MPLAUNCH {rank} fused_generation={fused_generation.launches}", flush=True)
            print(f"MPENGINE {rank} {sharded_engine(c, so, mesh)}", flush=True)
            print(f"MPTIME {rank} pop={c.population_size} generations={gens} "
                  f"ms_per_gen={ms:.4f} device={dev} backend={mesh.backend}", flush=True)
    if frames > 1:
        # the frame all-reduce against the unsharded multi-frame fitness
        lcfg = _local_cfg(cfg, mesh.axis_size(POP_AXIS))
        so = make_spectrum_ops(cfg, device=dev)
        tspec = target(cfg, so)
        values = torch.from_numpy(np.random.default_rng(FRAME_CHECK_SEED).random(
            (lcfg.population_size, cfg.num_dimensions)).astype(np.float32)).to(dev)
        got = frame_fitness(values, tspec, so, lcfg, mesh)
        want = evaluate(values, tspec, so, lcfg.replace(fused_kernel=False,
                                                         fused_generation=False))
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).double()
        print(f"MPFRAME {rank} candidates={values.shape[0]} max_rel={float(rel.max()):.3e} "
              f"median_rel={float(rel.median()):.3e}", flush=True)
    mesh.barrier()
    dist.destroy_process_group()
    return 0


def run(procs: int = 2, mesh2d: bool = False, platform: str = "cuda", cfg=None,
        generations: int = GENERATIONS) -> tuple[int, list[str]]:
    """Spawn the ranks and check them on ``cfg`` (by default ``config``;
    its ``num_frames`` must be 2 on the 2-D mesh) for ``generations``
    generations; returns ``(exit code, the ranks' MP* lines)``."""
    import json

    from .device import resolve_device
    from .utils.aot import config_to_dict

    resolve_device(platform)  # the card, unless the caller asks for the CPU
    if mesh2d and procs % 2:
        raise ValueError("--mesh2d needs an even number of ranks")
    if cfg is None:
        cfg = config(procs // 2 if mesh2d else procs, 2 if mesh2d else 1)
    if platform == "cuda":
        from .kernels import _build

        _build.library()  # built here, once, before any rank starts
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory(prefix="pmfm_mp_") as tmp:
        store = os.path.join(tmp, "store")
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(config_to_dict(cfg), f)
        procs_ = []
        for i in range(procs):
            env = dict(os.environ, LOCAL_RANK=str(i), LOCAL_WORLD_SIZE=str(procs),
                       PYTHONPATH=os.pathsep.join(
                           [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
            cmd = [sys.executable, "-m", "pmfm_tpu_torch.multiprocess_check", "--procs",
                   str(procs), "--child", str(i), "--store", store, "--platform", platform,
                   "--config", cfg_path, "--generations", str(generations)]
            cmd += ["--mesh2d"] if mesh2d else []
            procs_.append(subprocess.Popen(cmd, env=env,
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
        try:
            outs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs_]
        finally:
            for p in procs_:  # no rank left behind on a timeout or a failure
                if p.poll() is None:
                    p.kill()
                    p.wait()
    lines = []
    for i, (p, out) in enumerate(zip(procs_, outs)):
        if p.returncode != 0:
            print(out)
            print(f"rank {i} FAILED rc={p.returncode}")
            return 1, lines
        lines += [ln for ln in out.splitlines() if ln.startswith("MP")]
    return 0, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--mesh2d", action="store_true", help="2-D (pop x frame) mesh")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--generations", type=int, default=GENERATIONS, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--config", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        return child(args.child, args.procs, args.store, args.mesh2d, args.platform,
                     args.config, args.generations)
    code, lines = run(args.procs, args.mesh2d, args.platform)
    if code:
        return code
    print("\n".join(lines))
    checks = [ln for ln in lines if ln.startswith("MPCHK")]
    states = {ln.split("digest=")[1] for ln in checks}
    if len(checks) != args.procs or len(states) != 1:
        print(f"ranks disagree: {sorted(states)}")
        return 1
    print(f"OK: {args.procs} processes{' (2-D pop x frame mesh)' if args.mesh2d else ''} on "
          f"{args.platform}, every rank's final state byte-equal ({states.pop()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
