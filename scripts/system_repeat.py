"""Repeat chip_smoke.py's `system` and `loop` phases on one card: whether
their results repeat across runs of the same code (the async mapper's
hand-off, the closer and its global BA on the mapper worker, and the BA's
sums make the map depend only on the frames), how the system phase changes
when the same orbit is entered at a later frame (another initial pair, so
another map), and how the speed spreads; with the async mapper (the main
path, as chip_smoke.py runs it) and with the mapper and closer in the
tracker's thread (one keyframe at a time, at retire time).

    python3 scripts/system_repeat.py [n_repeat] [n_sync] [n_starts] [n_loop]

runs the async system phase n_repeat times from frame 0, the synchronous
one n_sync times, the async one entering the orbit at frames 8, 16, ...,
8 * n_starts, then the loop phase (bench.py's ring scene) n_loop times.
Prints the card's `nvidia-smi` name and power limit, one `system` / `loop`
line per run (a run whose gates fail is reported and the script goes on),
then one summary line {"runs": [...]} with each run's phase, mode, start
frame, ATE, keyframes, map points, the closer's counts, frames/s and failed
gates. Exits non-zero without a CUDA device.
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main(n_repeat=2, n_sync=0, n_starts=0, n_loop=0):
    if not torch.cuda.is_available():
        print("system_repeat: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(2)
    cs.phase_device()
    lines, emit = [], cs.emit
    cs.emit = lambda obj: (lines.append(obj), emit(obj))
    plan = ([(cs.phase_system, True, 0)] * n_repeat + [(cs.phase_system, False, 0)] * n_sync
            + [(cs.phase_system, True, 8 * (i + 1)) for i in range(n_starts)]
            + [(cs.phase_loop, True, 0)] * n_loop)
    runs = []
    for phase, mode, start in plan:
        failed = None
        try:
            phase(torch.device("cuda"), async_mapping=mode, start=start)
        except SystemExit as e:
            failed = str(e)
        r = lines[-1]
        runs.append({"phase": r["phase"], "async_mapping": mode, "start": start, "ate_m": r["ate_m"],
                     "ate_first_half_m": r["ate_first_half_m"],
                     "ate_scale_by_quarter": r["ate_scale_by_quarter"],
                     "keyframes": r["keyframes"], "map_points": r["map_points"],
                     "tracked_timed": r["tracked_timed"],
                     "keyframes_created_after_init": r["keyframes_created_after_init"],
                     "keyframe_decisions_backlogged": r["keyframe_decisions_backlogged"],
                     "frames_per_s": r["frames_per_s"], "chunk_ms_p50": r["chunk_ms_p50"],
                     "mapper_wait": r["frontend_stages"].get("mapper_wait"),
                     "launches": r["launches"], "maps_created": r["maps_created"],
                     "closer": {k: r["closer"][k] for k in ("queries", "verifications",
                                                            "loops_closed", "merges", "gba_runs",
                                                            "loops")},
                     "reloc": [r["reloc_attempts"], r["reloc_successes"]],
                     "largest_map_kf_ate_m": r["largest_map_kf_ate_m"],
                     "launches_by_stage": r["launches_by_stage"],
                     "verify_log": r["closer"]["verify_log"],
                     "failed": failed})
    print(json.dumps({"runs": runs}), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:5]))
