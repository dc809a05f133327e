"""ATE evaluation CLI, a drop-in for the reference's evaluate_ate_scale.py.

Port of orb_slam3_modified_tpu/eval/__main__.py (load_tum, main; :19-76).
Usage (the reference tool's positional convention,
evaluation/evaluate_ate_scale.py):

  python -m orb_slam3_modified_tpu_torch.eval gt.txt est.txt [--max-dt 0.02]
         [--no-scale] [--plot out.png]

Both files are TUM format: ts tx ty tz qx qy qz qw. --plot needs matplotlib,
imported only then.
"""
from __future__ import annotations

import argparse

import numpy as np

from .ate import align_horn, associate_by_timestamp


def load_tum(path):
    ts, pos = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            p = line.split()
            if len(p) < 4:
                continue
            ts.append(float(p[0]))
            pos.append([float(x) for x in p[1:4]])
    return np.array(ts), np.array(pos)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("gt")
    ap.add_argument("est")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--no-scale", action="store_true")
    ap.add_argument("--plot", default=None)
    args = ap.parse_args(argv)

    ts_g, p_g = load_tum(args.gt)
    ts_e, p_e = load_tum(args.est)
    pairs = associate_by_timestamp(ts_e, ts_g, args.max_dt)
    if len(pairs) < 2:
        raise SystemExit("no timestamp associations")
    ei = np.array([i for i, _ in pairs])
    gi = np.array([j for _, j in pairs])
    R, t, s, err = align_horn(p_e[ei].T, p_g[gi].T, not args.no_scale)
    rmse = float(np.sqrt(np.mean(err**2)))
    print(f"compared_pose_pairs {len(pairs)} pairs")
    print(f"absolute_translational_error.rmse {rmse:.6f} m")
    print(f"absolute_translational_error.mean {err.mean():.6f} m")
    print(f"absolute_translational_error.median {np.median(err):.6f} m")
    print(f"absolute_translational_error.std {err.std():.6f} m")
    print(f"absolute_translational_error.min {err.min():.6f} m")
    print(f"absolute_translational_error.max {err.max():.6f} m")
    print(f"scale {s:.6f}")
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        aligned = (s * R @ p_e[ei].T + t).T
        fig, ax = plt.subplots(figsize=(8, 8))
        ax.plot(p_g[gi, 0], p_g[gi, 1], "k-", label="ground truth")
        ax.plot(aligned[:, 0], aligned[:, 1], "b-", label="estimated")
        ax.legend()
        ax.set_aspect("equal")
        fig.savefig(args.plot, dpi=110)
        plt.close(fig)
    return rmse


if __name__ == "__main__":
    main()
