"""The ``pmfm`` command-line program on PyTorch/CUDA (port of ``pmfm_tpu/cli.py``).

    python -m pmfm_tpu_torch.cli -j parameters.json [options]

Replicates the reference program's main (main.cpp:25-305), as ``pmfm_tpu.cli`` does:

* ``-j/--json <config>`` selects the JSON run configuration;
* ``input: "params"`` synthesises the target from ground-truth parameters and
  writes ``inputGenerated.wav``; ``input: "audio"`` loads the target WAV
  (resampled to the config's rate where the file's differs);
* runs the chunked matcher (``es/pipeline.py::match_audio``); with
  ``--mode stft`` one run scored over every frame of the target
  (``match_audio_stft``); with ``--mode parallel-chunks`` one run a chunk,
  all chunks at once (``match_many``); with ``--mode pursuit`` /
  ``tpu.solver: "pursuit"`` the staged solver (``es/staged.py``: the series
  homotopy for fm{k}_series with k >= 4, the pair pursuit otherwise) chunk
  by chunk; and prints the total wall-clock time;
* with ``--batch a.wav b.wav ...`` matches several target files at once
  (``match_many``: each file resampled to the config's rate, all cut to the
  shortest whole number of frames, one output WAV a target named after it);
* prints the best parameters and fitness per chunk, then the overall best
  by parameter name (``models.get_topology``);
* resynthesises the best candidates into the output WAV;
* with ``general.isBenchmarking``, writes the per-stage benchmark CSV with
  the reference's naming scheme and column schema (backend tag ``gpu``);
  every mode but ``chunks`` (which times each chunk) is timed as one
  "Total Audio Analysis Time".

* with ``--checkpoint-dir D`` writes each finished chunk into D and a
  rerun resumes after the last one (``match_audio``); with ``--mode stft``
  and ``--checkpoint-every N`` too, the run's state every N generations
  (``match_audio_stft``);
* with ``--export-aot PATH`` writes an artifact of the STFT matcher for the
  config and the target's length (``utils/aot.py``: the config and the
  built kernel library; with a mesh, its rank count as ``mesh_devices``)
  and exits; with ``--aot PATH`` runs from one, its config in place of the
  JSON's, without building the kernels;
* with ``--mesh N`` (or a config's ``tpu.meshShape`` and
  ``tpu.meshAxisNames``, e.g. ``[2, 2]`` and ``["pop", "frame"]``) shards
  the population over a mesh of ranks (``parallel/``) in the chunks, stft,
  parallel-chunks and batch modes; the pursuit solver runs on each rank
  alone, as the reference's does. Several ranks are started with

      python -m torch.distributed.run --nproc-per-node N -m pmfm_tpu_torch.cli -j C --mesh N

  (NCCL where each rank has a card of its own, gloo where ranks share one
  or run on the CPU; ``parallel/mesh.py``). Without that launcher ``--mesh
  1`` runs a world of one and a larger mesh raises ``ValueError``. Every
  rank computes the same result; the first writes the WAV, the CSV, the
  checkpoints and the ``--profile-dir`` trace and prints.

The run is on the first CUDA device (a rank's own under the launcher)
unless ``--platform cpu`` asks for the CPU, where every kernel runs its
plain PyTorch version.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def show_usage() -> str:
    # reference usage text analog (main.cpp:368-415)
    return (
        "pmfm — evolutionary FM parameter matcher on PyTorch/CUDA\n"
        "usage: python -m pmfm_tpu_torch.cli -j <config.json> [options]\n"
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pmfm", description=show_usage())
    p.add_argument("-j", "--json", default="parameters.json", help="run configuration JSON")
    p.add_argument("--seed", type=int, default=0, help="PRNG seed")
    p.add_argument("--generations", type=int, default=None, help="override numGenerations")
    p.add_argument("--parents", type=int, default=None, help="override numParents")
    p.add_argument("--offspring", type=int, default=None, help="override numOffspring")
    p.add_argument("--audio-log2", type=int, default=None, help="override audioLengthLog2")
    p.add_argument("--checkpoint-dir", default=None, help="chunk-level checkpoint/resume dir")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="stft mode: also checkpoint the ES state every N generations "
                        "(resumable mid-run)")
    p.add_argument("--trajectory", action="store_true", help="record per-generation best fitness")
    p.add_argument("--mode",
                   choices=("chunks", "stft", "parallel-chunks", "pursuit"),
                   default="chunks",
                   help="chunks: fresh population per chunk, sequential (reference "
                        "semantics); stft: one run scored over every frame of the target "
                        "(multi-frame STFT fitness); parallel-chunks: one run a chunk, all "
                        "chunks at once (batched); pursuit, the staged solver for "
                        "fm{k}_parallel, fm2 and fm{k>=4}_series. A config with "
                        "tpu.solver='pursuit' selects pursuit")
    p.add_argument("--batch", nargs="+", default=None, metavar="WAV",
                   help="match several target WAVs concurrently (one batched run a file, "
                        "each over all its frames)")
    p.add_argument("--mesh", type=int, default=None,
                   help="shard the population over a mesh of N ranks (launch them with "
                        "python -m torch.distributed.run --nproc-per-node N)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace (trace.json) here (the first "
                        "rank's, under a mesh)")
    p.add_argument("--export-aot", default=None, metavar="PATH",
                   help="write an AOT artifact of the STFT matcher for this config and target "
                        "length (the config and the built kernel library) and exit")
    p.add_argument("--aot", default=None, metavar="PATH",
                   help="run from an AOT artifact (see --export-aot) instead of building the "
                        "kernels")
    p.add_argument("--input-generated-path", default="inputGenerated.wav",
                   help="where params-mode targets are written (main.cpp:226)")
    p.add_argument("--platform", default=None, metavar="NAME",
                   help="'cuda' (the default: the first CUDA device) or 'cpu' (the "
                        "kernels' plain PyTorch versions)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--list-devices", action="store_true",
                   help="print the CUDA devices and exit (printAvailableDevices analog)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    started = []  # a world this call started, ended on the way out
    try:
        return _main(args, started)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(args, started: list) -> int:
    # heavy imports deferred so that `--help` is instant
    import torch

    if args.list_devices:
        # printAvailableDevices analog (Evolutionary_Strategy_OpenCL.hpp:634-680)
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        for i in range(count):
            p = torch.cuda.get_device_properties(i)
            print(f"{i}: {p.name} (platform=cuda, {p.total_memory / 2**30:.1f} GiB, "
                  f"{p.multi_processor_count} SMs)")
        if not count:
            print("no CUDA device (torch.cuda.is_available() is False)")
        return 0

    platform = args.platform or "cuda"
    if platform not in ("cuda", "cpu"):
        print(f"error: --platform must be 'cuda' or 'cpu', got {platform!r}", file=sys.stderr)
        return 2
    # The reference enables JAX's persistent compile cache here
    # (utils/compile_cache.py). It has no counterpart: the port compiles its
    # CUDA kernels once per source hash into build/pmfm_tpu_torch/
    # (kernels/_build.py) and PyTorch's own kernels need no compilation.
    from .device import resolve_device
    from .es import match_audio
    from .io import load_config, read_audio, resample, write_wav
    from .models import get_topology
    from .ops import synthesize_single
    from .utils import Benchmarker
    from .utils.debug import debug_nans
    from .utils.profiling import maybe_trace

    try:
        run_cfg = load_config(args.json)
    except FileNotFoundError:
        print(f"error: config file not found: {args.json}", file=sys.stderr)
        print(show_usage(), file=sys.stderr)
        return 2

    cfg = run_cfg.es
    if args.mode == "chunks" and run_cfg.solver == "pursuit":
        args.mode = "pursuit"

    # --- mesh (population sharding over ranks; the reference's cli.py:274-282)
    mesh = None
    mesh_shape = (args.mesh,) if args.mesh else run_cfg.mesh_shape
    if (mesh_shape or args.aot) and not args.export_aot:
        from .parallel import initialize_multihost, make_mesh
        from .parallel.mesh import local_device

        dev = local_device(platform)
        size = int(np.prod(mesh_shape)) if mesh_shape else None
        if initialize_multihost(mesh_size=size, device=dev):
            started.append(True)
        if mesh_shape:
            mesh = make_mesh(mesh_shape, run_cfg.mesh_axis_names, device=dev)
            if dev.type == "cuda" and not args.aot:
                from .kernels import _build

                if mesh.is_root:  # one build, which the other ranks then load
                    _build.library()
                mesh.barrier()
    device = mesh.device if mesh is not None else resolve_device(platform)
    import torch.distributed as dist

    root = not dist.is_initialized() or dist.get_rank() == 0
    if not root:  # the first rank prints and writes the files
        args.quiet = True
        run_cfg = dataclasses.replace(run_cfg, is_audio=False, is_benchmarking=False)

    overrides = {}
    if args.parents is not None:
        overrides["num_parents"] = args.parents
    if args.offspring is not None:
        overrides["num_offspring"] = args.offspring
    if args.audio_log2 is not None:
        overrides["audio_length_log2"] = args.audio_log2
    if overrides:
        cfg = cfg.replace(**overrides)
    num_generations = (
        args.generations if args.generations is not None else run_cfg.num_generations
    )

    # --- benchmarking setup (reference CSV naming) ------------------------
    bm = None
    if run_cfg.is_benchmarking:
        csv_path = (
            Benchmarker.log_filename("gpu", cfg.population_size, num_generations, cfg.n_samples)
            if run_cfg.is_log
            else None
        )
        bm = Benchmarker(csv_path=csv_path, quiet=args.quiet,
                         population=cfg.population_size, generations=num_generations)

    if args.batch:
        return _match_batch(args, run_cfg, cfg, num_generations, device, bm, mesh)

    # --- target creation (main.cpp:204-227) ------------------------------
    if run_cfg.input_mode == "params":
        params = np.asarray(run_cfg.input_params, np.float32)
        if params.size != cfg.num_dimensions:
            print(
                f"error: type.params has {params.size} values, config needs "
                f"{cfg.num_dimensions}",
                file=sys.stderr,
            )
            return 2
        # main.cpp synthesises a 2^11-sample target whatever the chunk size;
        # at least one chunk here
        n_target = max(2048, cfg.n_samples)
        target = synthesize_single(
            torch.from_numpy(params).to(device), n_target, cfg.topology,
            wavetable_size=cfg.wavetable_size, sample_rate=cfg.sample_rate,
            osc_mode=cfg.osc_mode,
        ).cpu().numpy()
        if run_cfg.is_audio:
            write_wav(args.input_generated_path, target, cfg.sample_rate, normalize=True)
        sample_rate = cfg.sample_rate
    elif run_cfg.input_mode == "audio":
        target, sample_rate = read_audio(run_cfg.input_audio_path)
        if sample_rate != cfg.sample_rate:
            # match at the synthesis engine's rate (bandlimited resample)
            target = resample(target, sample_rate, cfg.sample_rate)
            if not args.quiet:
                print(f"resampled target {sample_rate} Hz -> {cfg.sample_rate} Hz "
                      f"({len(target)} samples)")
            sample_rate = cfg.sample_rate
    else:
        print(f"error: unknown input mode {run_cfg.input_mode!r}", file=sys.stderr)
        return 2

    # --- AOT export / serve (utils/aot.py) --------------------------------
    from .utils import aot

    if args.export_aot:
        n = len(target) - len(target) % cfg.n_samples
        if n == 0:
            print("error: target shorter than one frame", file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        aot_mesh = int(np.prod(mesh_shape)) if mesh_shape else None  # the reference's cli.py:262
        path = aot.save_matcher(args.export_aot, cfg, num_generations, target_samples=n,
                                platforms=(device.type,), mesh_devices=aot_mesh)
        if not args.quiet:
            print(f"exported AOT matcher to {path} ({os.path.getsize(path)} bytes, "
                  f"target_samples={n}, generations={num_generations}, platform {device.type}"
                  + (f", mesh_devices={aot_mesh}" if aot_mesh else "")
                  + f"; {time.perf_counter() - t0:.3f}s)")
        return 0
    matcher = None
    if args.aot:
        t0 = time.perf_counter()
        matcher = aot.load_matcher(args.aot)
        if matcher.platforms[0] != device.type:
            raise ValueError(f"the artifact is for {matcher.platforms[0]}, the run is on "
                             f"{device.type} (--platform)")
        cfg, num_generations = matcher.cfg, matcher.num_generations  # self-describing
        if len(target) < matcher.target_samples:
            print(f"error: target has {len(target)} samples; artifact expects "
                  f"{matcher.target_samples}", file=sys.stderr)
            return 2
        if not args.quiet:
            print(f"loaded AOT matcher {args.aot} in {time.perf_counter() - t0:.3f}s")

    # --- match (main.cpp:229-239) ----------------------------------------
    from .es import make_spectrum_ops, match_audio_stft, match_many
    from .es.pipeline import ChunkResult, MatchResult
    from .es.strategy import active_engine

    if args.mode == "stft" and matcher is None:  # one run over every frame: multi-frame engines
        cfg = cfg.replace(num_frames=max(1, len(target) // cfg.n_samples))
    # the engines are named (and an engine not ported raises) before matching
    if matcher is not None:
        line = _engine_line(cfg, num_generations, device, "AOT artifact, stft")
    elif args.mode == "pursuit":
        from .es.staged import _eval_cfg

        ecfg = _eval_cfg(cfg)
        line = (f"engine: {_engines(cfg, num_generations, device)} (the polishes) and "
                f"{active_engine(ecfg, make_spectrum_ops(ecfg, device=device))} (the block "
                f"stages) on {device} (pursuit solver, {cfg.topology}, n={cfg.n_samples}, "
                f"pop={cfg.population_size})")
    else:
        line = _engine_line(cfg, num_generations, device, f"{args.mode} mode", mesh)
    if not args.quiet:
        print(line)
    start = time.perf_counter()
    # the chunks mode feeds the Benchmarker chunk by chunk; every other mode
    # is timed as one total, so that isBenchmarking writes the CSV in each
    total = bm is not None and (args.mode != "chunks" or matcher is not None)
    if total:
        bm.start_timer("Total Audio Analysis Time")
    # general.isDebug: NaN checks over the whole match (utils/debug.py)
    with maybe_trace(args.profile_dir if root else None), debug_nans(run_cfg.is_debug):
        if matcher is not None:
            out = matcher(args.seed, target[: matcher.target_samples])
            result = MatchResult(chunks=[ChunkResult(
                best_params_scaled=out["best_params_scaled"],
                best_params_norm=out["best_params_norm"],
                best_fitness=float(out["best_fitness"]),
                generations_run=int(out["generations_run"]),
                trajectory=None,
            )], output_audio=out["best_audio"], config=cfg)
        elif args.mode == "pursuit":
            result = _match_pursuit(target, cfg, run_cfg.pursuit, args.seed, device, args.quiet)
        elif args.mode == "stft":
            result = match_audio_stft(
                target, cfg, seed=args.seed, num_generations=num_generations,
                record_trajectory=args.trajectory, checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every, mesh=mesh, device=device,
            )
        elif args.mode == "parallel-chunks":
            n = len(target) - len(target) % cfg.n_samples
            if n == 0:
                raise ValueError(f"target audio ({len(target)} samples) shorter than one frame "
                                 f"({cfg.n_samples})")
            chunks = np.asarray(target[:n], np.float32).reshape(-1, cfg.n_samples)
            many = match_many(chunks, cfg, seed=args.seed, num_generations=num_generations,
                              mesh=mesh, device=device)
            result = MatchResult(chunks=[r.chunks[0] for r in many],
                                 output_audio=np.concatenate([r.output_audio for r in many]),
                                 config=cfg)
        else:
            result = match_audio(
                target, cfg, seed=args.seed, num_generations=num_generations,
                record_trajectory=args.trajectory, benchmarker=bm,
                checkpoint_dir=args.checkpoint_dir, mesh=mesh, device=device,
            )
    if total:
        bm.pause_timer("Total Audio Analysis Time")
    elapsed = time.perf_counter() - start
    if not args.quiet:
        print(f"Total time to complete: {elapsed:.3f}s")
        print(f"Total time to complete: {elapsed * 1e3:.3f}ms\n")

    # --- report (printBest analog) ---------------------------------------
    evals = cfg.population_size * sum(c.generations_run for c in result.chunks)
    if not args.quiet:
        for i, c in enumerate(result.chunks):
            params_str = ", ".join(f"{v:.3f}" for v in c.best_params_scaled)
            print(f"chunk {i}: fitness = {c.best_fitness:.6g} "
                  f"({c.generations_run} generations)\n  params = [{params_str}]")
        best = result.best_chunk
        names = get_topology(cfg.topology).param_names
        print(f"\nOverall best parameters found\n Fitness = {best.best_fitness:f}")
        print("  " + ", ".join(f"{nm}={v:.4f}" for nm, v in zip(names, best.best_params_scaled)))
        print(f"candidate evaluations: {evals} ({evals / elapsed:.0f}/s)")

    # --- output audio (main.cpp:270-275) ---------------------------------
    if run_cfg.is_audio:
        write_wav(run_cfg.output_audio_path, result.output_audio, sample_rate, normalize=True)
        if not args.quiet:
            print(f"wrote {run_cfg.output_audio_path}")

    if bm is not None:
        _flush_benchmark(bm, cfg, device)
    return 0


def _engines(cfg, num_generations: int, device, mesh=None) -> str:
    """The engine of ``cfg`` on ``device`` (over ``mesh``, the engine a
    sharded generation runs: ``parallel.sharded.sharded_engine``) and, with
    a refine tail, the tail's ("X, the last R on Y")."""
    from .es import make_spectrum_ops
    from .es.strategy import active_engine

    def engine(c):
        so = make_spectrum_ops(c, device=device)
        if mesh is None:
            return active_engine(c, so)
        from .parallel.sharded import sharded_engine

        return sharded_engine(c, so, mesh)

    if cfg.refine_generations <= 0:
        return engine(cfg)
    return (f"{engine(cfg)}, the last {min(cfg.refine_generations, num_generations)} on "
            f"{engine(cfg.refine_config())}")


def _engine_line(cfg, num_generations: int, device, mode: str, mesh=None) -> str:
    """The "engine: ..." line: ``_engines`` on ``device``, the mode, the
    shapes, where there are several the frames a run is scored over, and
    the mesh with a rank's share of the population."""
    frames = f", {cfg.num_frames} frames a run" if cfg.num_frames > 1 else ""
    shards = ""
    if mesh is not None:
        from .parallel import POP_AXIS

        shards = (f", mesh {mesh.shape} on {mesh.backend}, "
                  f"{cfg.population_size // mesh.axis_size(POP_AXIS)} a rank")
    return (f"engine: {_engines(cfg, num_generations, device, mesh)} on {device} ({mode}, "
            f"{cfg.topology}, n={cfg.n_samples}{frames}, pop={cfg.population_size}{shards}, "
            f"{num_generations} generations)")


def _match_batch(args, run_cfg, cfg, num_generations: int, device, bm, mesh=None) -> int:
    """``--batch``: every WAV of ``args.batch`` resampled to the config's
    rate, all cut to the shortest whole number of frames, matched at once
    (``match_many``, one run a file, each over all its frames); prints each
    target's fitness and parameters, writes one WAV a target (the output
    path with the target's stem after it) and the benchmark CSV."""
    from .es import match_many
    from .io import read_audio, resample, write_wav

    loaded = []
    for path in args.batch:
        a, sr = read_audio(path)
        if sr != cfg.sample_rate:
            a = resample(a, sr, cfg.sample_rate)
            if not args.quiet:
                print(f"{path}: resampled {sr} Hz -> {cfg.sample_rate} Hz")
            sr = cfg.sample_rate
        loaded.append((a, sr))
    n = min(len(a) for a, _ in loaded)
    n -= n % cfg.n_samples
    if n == 0:
        print("error: batch targets shorter than one frame", file=sys.stderr)
        return 2
    targets = np.stack([a[:n] for a, _ in loaded])
    if not args.quiet:
        print(_engine_line(cfg.replace(num_frames=n // cfg.n_samples), num_generations, device,
                           f"a batch of {len(loaded)} targets", mesh))
    start = time.perf_counter()
    if bm is not None:
        bm.start_timer("Total Audio Analysis Time")
    results = match_many(targets, cfg, seed=args.seed, num_generations=num_generations,
                         mesh=mesh, device=device)
    if bm is not None:
        bm.pause_timer("Total Audio Analysis Time")
    elapsed = time.perf_counter() - start
    seen: set = set()
    for i, (path, r) in enumerate(zip(args.batch, results)):
        c = r.chunks[0]
        params_str = ", ".join(f"{v:.3f}" for v in c.best_params_scaled)
        if mesh is None or mesh.is_root:
            print(f"{path}: fitness = {c.best_fitness:.6g}\n  params = [{params_str}]")
        if run_cfg.is_audio:
            root, ext = os.path.splitext(run_cfg.output_audio_path)
            stem = os.path.splitext(os.path.basename(path))[0]
            out_path = f"{root}_{stem}{ext or '.wav'}"
            if out_path in seen:  # the same file name twice: tell them apart
                out_path = f"{root}_{stem}_{i}{ext or '.wav'}"
            seen.add(out_path)
            write_wav(out_path, r.output_audio, loaded[i][1], normalize=True)
    if not args.quiet:
        print(f"\nTotal time to complete: {elapsed:.3f}s ({len(results)} targets, concurrent)")
    if bm is not None:
        _flush_benchmark(bm, cfg, device)
    return 0


def _match_pursuit(target, cfg, pursuit_items, seed: int, device, quiet: bool):
    """The staged solver over each whole chunk of ``target`` (the reference
    CLI's pursuit mode): ``match_series_pursuit`` for fm{k}_series with
    k >= 4, else ``match_parallel_pursuit`` (which raises ``ValueError`` for
    a topology that is neither fm{k}_parallel nor fm2), each chunk on its
    own sub-seed. Prints a line a chunk: attempts, generations, the relative
    spectral error under the f32 engine against ``targetRel``, and the
    seconds of each part. Returns a ``MatchResult``."""
    import torch

    from .es.pipeline import ChunkResult, MatchResult, _chunk_seed
    from .es.staged import (
        _eval_cfg,
        _spectrum_ops,
        match_parallel_pursuit,
        match_series_pursuit,
        pursuit_kwargs_from_config,
        series_pursuit_kwargs_from_config,
    )
    from .es.strategy import evaluate
    from .ops import synthesize_single, target_spectrum
    from .ops.synthesis import scale_params, series_ops

    # parallel banks -> the comb-peel solver; serial chains k >= 4 -> the
    # exact-reduction homotopy (each has its own knob set)
    if (series_ops(cfg.topology) or 0) >= 4:
        solver, kw = match_series_pursuit, series_pursuit_kwargs_from_config(pursuit_items)
    else:
        solver, kw = match_parallel_pursuit, pursuit_kwargs_from_config(pursuit_items)
    n = cfg.n_samples
    n_chunks = len(target) // n
    if n_chunks == 0:
        raise ValueError(f"target audio ({len(target)} samples) shorter than one frame ({n})")
    mins = torch.tensor(cfg.param_mins, dtype=torch.float32, device=device)
    maxs = torch.tensor(cfg.param_maxs, dtype=torch.float32, device=device)
    ecfg = _eval_cfg(cfg)
    so_e = _spectrum_ops(ecfg, device)
    chunks, out_audio = [], []
    for i in range(n_chunks):
        frame = np.ascontiguousarray(target[i * n : (i + 1) * n], np.float32)
        r = solver(frame, cfg, _chunk_seed(seed, i), device=device, **kw)
        values = torch.from_numpy(np.asarray(r.best_values, np.float32)).to(device)
        best_scaled = scale_params(values[None], mins, maxs)[0]
        chunks.append(ChunkResult(
            best_params_scaled=best_scaled.cpu().numpy(),
            best_params_norm=np.asarray(r.best_values, np.float32),
            best_fitness=float(r.best_fitness),
            generations_run=r.generations_used,
            trajectory=None,
        ))
        out_audio.append(synthesize_single(
            best_scaled, n, cfg.topology, wavetable_size=cfg.wavetable_size,
            sample_rate=cfg.sample_rate, osc_mode=cfg.osc_mode, engine=cfg.synthesis_engine,
        ).cpu().numpy())
        if not quiet:
            tspec = target_spectrum(torch.from_numpy(frame).to(device), so_e)
            energy = float(torch.sum(tspec.double() ** 2))
            f32 = float(evaluate(values[None], tspec, so_e, ecfg)[0])
            rel = (f32 / energy) ** 0.5 if energy > 0 else float("nan")
            goal = kw.get("target_rel", 0.0)
            met = f"{'met' if rel <= goal else 'not met'}" if goal > 0 else "not set"
            parts = ", ".join(f"{k} {v:.3f}s" for k, v in (r.seconds or {}).items())
            print(f"pursuit chunk {i}: attempts {r.attempts}, generations {r.generations_used}, "
                  f"f32 fitness {f32:.6g}, silent estimate {energy:.6g}, relative spectral "
                  f"error {rel:.6g} (targetRel {goal:g}: {met}); stage fitness "
                  f"{np.round(r.stage_fitness, 6).tolist()}; seconds {parts}")
    return MatchResult(chunks=chunks, output_audio=np.concatenate(out_audio), config=cfg)


def _flush_benchmark(bm, cfg, device) -> None:
    """End-of-run CSV flush in the reference's order
    (Evolutionary_Strategy_OpenCL.hpp:601-609): one row per pipeline stage
    (utils/stage_bench.py), then the chunk row and "Total Audio Analysis
    Time"."""
    from .utils.stage_bench import record_stage_rows

    try:
        record_stage_rows(bm, cfg, device=device)
    except Exception as e:  # noqa: BLE001 — benchmarking must not kill a run
        print(f"warning: per-stage benchmark rows skipped: {type(e).__name__}: {e}",
              file=sys.stderr)
    if bm.has_timer("chunk"):
        bm.elapsed_timer("chunk")
    bm.elapsed_timer("Total Audio Analysis Time")
    bm.close()


def run() -> int:
    """Entry point with the reference's catch-all (main.cpp:282-288 prints
    the exception); returns a nonzero exit code."""
    try:
        return main()
    except KeyboardInterrupt:
        return 130
    except Exception as e:  # noqa: BLE001 — CLI boundary
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(run())
