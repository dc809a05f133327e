"""chip_smoke.py's `loop` phase on a longer ring: bench.py's ring scene at
the same speed (400 frames a revolution) run past one revolution, so the
camera comes round over the first frames' ground for longer, and what the
closer does there.

    python3 scripts/ring_revisit.py [revolutions] [n_frames]

(default 1.25 revolutions in 500 frames) on one card. Prints the card's
`nvidia-smi` name and power limit, the phase's `loop` line (its gates are
those of bench.py's one revolution, reported and not enforced here), then
one summary line: tracked timed frames, ATE, the largest map's keyframe
ATE, keyframes, points, maps, loops closed and merges, global BA runs, the
closer's stage times, relocalization attempts and successes, frames/s, chunk
ms, every verification (keyframe pair by frame id, and the match, RANSAC
and refined inlier counts its gates saw) and every query (the keyframe, the
candidates it returned, and the keyframes more than 100 frames older that
it excluded as covisible, weight >= 15), all by frame id. Exits non-zero
without a CUDA device.
"""
import functools
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main(revolutions=1.25, n_frames=500):
    if not torch.cuda.is_available():
        print("ring_revisit: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(2)
    from orb_slam3_modified_tpu_torch.utils import synthetic_dataset

    cs.phase_device()
    synthetic_dataset.ring_trajectory = functools.partial(synthetic_dataset.ring_trajectory,
                                                          revolutions=revolutions)
    cs.N_LOOP_FRAMES = n_frames
    queries = _log_queries()
    lines, emit = [], cs.emit
    cs.emit = lambda obj: (lines.append(obj), emit(obj))
    failed = None
    try:
        cs.phase_loop(torch.device("cuda", 0))
    except SystemExit as e:
        failed = str(e)
    r = lines[-1]
    c = r["closer"]
    print(json.dumps({
        "revolutions": revolutions, "frames": n_frames, "timed_frames": r["timed_frames"],
        "tracked_timed": r["tracked_timed"], "ate_m": r["ate_m"],
        "largest_map_kf_ate_m": r["largest_map_kf_ate_m"], "keyframes": r["keyframes"],
        "map_points": r["map_points"], "maps_created": r["maps_created"],
        "loops": c["loops"], "loops_closed": c["loops_closed"], "merges": c["merges"],
        "gba_runs": c["gba_runs"], "queries": c["queries"], "stages": c["stages"],
        "reloc": [r["reloc_attempts"], r["reloc_successes"]], "frames_per_s": r["frames_per_s"],
        "chunk_ms_p50": r["chunk_ms_p50"], "chunk_ms_p90": r["chunk_ms_p90"],
        "verify_log": c["verify_log"], "query_log": queries,
        "bench_ring_gates_failed": failed}), flush=True)


def _log_queries():
    """Wrap the closer's detection to log each query by frame id."""
    from orb_slam3_modified_tpu_torch.loop.loop_closer import LoopCloser

    log, detect = [], LoopCloser._detect

    def logged(self, k, words):
        m = self.map
        cur = int(m.kf_frame_id[k])
        covisible = np.flatnonzero(m.covisibility_weights(k) >= 15)
        rec = {"kf": cur, "candidates": [],
               "old_excluded": sorted(int(m.kf_frame_id[x]) for x in covisible
                                      if m.kf_frame_id[x] < cur - 100)}
        query = self.kfdb.query

        def recorded(*a, **kw):
            got = query(*a, **kw)
            rec["candidates"] = [int(m.kf_frame_id[x]) for x in got]
            return got

        self.kfdb.query = recorded
        try:
            return detect(self, k, words)
        finally:
            del self.kfdb.query
            log.append(rec)

    LoopCloser._detect = logged
    return log


if __name__ == "__main__":
    main(*(float(a) if i == 0 else int(a) for i, a in enumerate(sys.argv[1:3])))
