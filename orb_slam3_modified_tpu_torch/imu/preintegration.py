"""IMU preintegration (Forster et al. style, float32).

Port of orb_slam3_modified_tpu/imu/preintegration.py (IMU::Preintegrated,
include/ImuTypes.h:129-240, IntegrateNewMeasurement src/ImuTypes.cc:177):
the delta rotation / velocity / position between two frames, the 15x15
covariance [rot, vel, pos, bg, ba], the bias jacobians JRg, JVg, JVa, JPg,
JPa, the first-order bias-corrected getters, and the closed-form merge of
two intervals.

The reference integrates one frame gap as one jitted lax.scan over a padded
batch with a validity mask, and a chunk's frame gaps as a vmap of it
(tracking/vi_fused.py::integrate_chunk). Here the scan is a Python loop
over the samples of eager torch on the samples' device, batched over any
leading axes (a chunk's K frames step together), with the same mask
semantics: a sample whose `valid` is False leaves every field untouched,
through torch.where, so the loop reads nothing back. A frame gap at 200 Hz
/ 20 fps is ten samples. Gravity and the noise model are the reference's
(GRAVITY_VALUE = 9.81, include/ImuTypes.h:43).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..lie import so3

GRAVITY = 9.81


def gravity_vec(like: torch.Tensor) -> torch.Tensor:
    """(3,) world gravity [0, 0, -9.81] on the dtype / device of `like`."""
    return torch.tensor([0.0, 0.0, -GRAVITY], dtype=like.dtype, device=like.device)


class ImuCalib(NamedTuple):
    """IMU::Calib (include/ImuTypes.h:92)."""

    R_bc: torch.Tensor  # (3, 3) camera-to-body rotation
    t_bc: torch.Tensor  # (3,)
    noise_gyro: float = 1.7e-4  # rad/s/sqrt(Hz)
    noise_acc: float = 2.0e-3  # m/s^2/sqrt(Hz)
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3.0e-3
    freq: float = 200.0


class ImuBias(NamedTuple):
    """Gyro + accelerometer bias (IMU::Bias, include/ImuTypes.h:62)."""

    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)

    @staticmethod
    def zero(device="cpu", dtype=torch.float32):
        return ImuBias(torch.zeros(3, dtype=dtype, device=device),
                       torch.zeros(3, dtype=dtype, device=device))


class Preintegrated(NamedTuple):
    """Accumulated deltas between two frames / keyframes
    (IMU::Preintegrated's state, include/ImuTypes.h:188-206)."""

    dT: torch.Tensor  # () total time
    dR: torch.Tensor  # (3, 3)
    dV: torch.Tensor  # (3,)
    dP: torch.Tensor  # (3,)
    C: torch.Tensor  # (15, 15) covariance
    JRg: torch.Tensor  # (3, 3) d dR / d bg
    JVg: torch.Tensor  # (3, 3)
    JVa: torch.Tensor  # (3, 3)
    JPg: torch.Tensor  # (3, 3)
    JPa: torch.Tensor  # (3, 3)
    bias: ImuBias  # linearization bias
    avg_a: torch.Tensor  # (3,) mean specific force
    avg_w: torch.Tensor  # (3,)

    @staticmethod
    def identity(bias: ImuBias | None = None, device=None, dtype=torch.float32):
        if bias is None:
            bias = ImuBias.zero(device or "cpu", dtype)
        dev, dt = bias.bg.device, bias.bg.dtype
        z3 = torch.zeros((3, 3), dtype=dt, device=dev)
        z = torch.zeros(3, dtype=dt, device=dev)
        return Preintegrated(
            dT=torch.zeros((), dtype=dt, device=dev), dR=torch.eye(3, dtype=dt, device=dev),
            dV=z, dP=z, C=torch.zeros((15, 15), dtype=dt, device=dev),
            JRg=z3, JVg=z3, JVa=z3, JPg=z3, JPa=z3, bias=bias, avg_a=z, avg_w=z,
        )


def _mv(M, v):
    """M @ v over leading batch axes (one frame: the plain product)."""
    return M @ v if v.dim() == 1 else (M @ v[..., None])[..., 0]


def _T(M):
    return M.transpose(-1, -2)


def _blocks(rows):
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def integrate(acc, gyro, dts, valid, bias: ImuBias, noise_gyro: float = 1.7e-4,
              noise_acc: float = 2.0e-3, walk_gyro: float = 1.9e-5, walk_acc: float = 3.0e-3,
              freq: float = 200.0) -> Preintegrated:
    """Integrate a (padded) batch of samples: acc, gyro (..., N, 3), dts
    (..., N), valid (..., N) bool, all on one device; bias fields (3,) or
    (..., 3). Leading axes are independent intervals (a chunk's frames,
    the reference's integrate_chunk, a vmap of integrate): one loop over
    the N samples steps them all, so trim N to the largest valid count.

    Discrete noise: sigma_d = sigma * sqrt(freq) (Calib::Set builds
    Cov = sigma^2 * freq * I)."""
    dev, dt_ = acc.device, acc.dtype
    batch = acc.shape[:-2]
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    z3 = torch.zeros(batch + (3, 3), dtype=dt_, device=dev)
    ng2 = (noise_gyro ** 2) * freq
    na2 = (noise_acc ** 2) * freq
    wg2 = (walk_gyro ** 2) / freq
    wa2 = (walk_acc ** 2) / freq
    Nga = torch.diag(torch.tensor([ng2] * 3 + [na2] * 3, dtype=dt_, device=dev))
    # walk variance grows with time: (walk^2 / freq) * freq * dt = walk^2 dt
    Cw_rate = torch.diag(torch.tensor([wg2] * 3 + [wa2] * 3, dtype=dt_, device=dev)) * freq
    pre = Preintegrated.identity(bias)
    if batch:
        pre = Preintegrated(*(x.expand(batch + x.shape).clone() for x in pre[:10]),
                            ImuBias(*(b.expand(batch + (3,)) for b in bias)),
                            *(x.expand(batch + x.shape).clone() for x in pre[11:]))
    sum_a = torch.zeros(batch + (3,), dtype=dt_, device=dev)
    sum_w = torch.zeros(batch + (3,), dtype=dt_, device=dev)
    n = torch.zeros(batch, dtype=dt_, device=dev)
    for i in range(acc.shape[-2]):
        a, w, dt, ok = acc[..., i, :], gyro[..., i, :], dts[..., i], valid[..., i]
        dt1, dt3 = dt[..., None], dt[..., None, None]
        a_c = a - pre.bias.ba
        w_c = w - pre.bias.bg
        dt2 = dt3 * dt3
        Ra = _mv(pre.dR, a_c)
        # position / velocity with the CURRENT dR (as the reference)
        dP_new = pre.dP + pre.dV * dt1 + 0.5 * Ra * (dt1 * dt1)
        dV_new = pre.dV + Ra * dt1
        # covariance propagation (the A / B matrices, src/ImuTypes.cc:196)
        hat_a = so3.hat(a_c)
        dRi = so3.exp(w_c * dt1)
        Jr = so3.right_jacobian(w_c * dt1)
        RH = pre.dR @ hat_a
        A = _blocks([[_T(dRi), z3, z3], [-RH * dt3, eye3 + z3, z3],
                     [-0.5 * RH * dt2, eye3 * dt3, eye3 + z3]])
        B = _blocks([[Jr * dt3, z3], [z3, pre.dR * dt3], [z3, 0.5 * pre.dR * dt2]])
        C9 = A @ pre.C[..., :9, :9] @ _T(A) + B @ Nga @ _T(B)
        Cw = pre.C[..., 9:, 9:] + Cw_rate * dt3
        C_new = _blocks([[C9, pre.C[..., :9, 9:]], [pre.C[..., 9:, :9], Cw]])
        # bias jacobians (src/ImuTypes.cc:221-229)
        new = Preintegrated(
            dT=pre.dT + dt,
            dR=so3.normalize(pre.dR @ dRi), dV=dV_new, dP=dP_new, C=C_new,
            JRg=_T(dRi) @ pre.JRg - Jr * dt3,
            JVg=pre.JVg - RH @ pre.JRg * dt3,
            JVa=pre.JVa - pre.dR * dt3,
            JPg=pre.JPg + pre.JVg * dt3 - 0.5 * RH @ pre.JRg * dt2,
            JPa=pre.JPa + pre.JVa * dt3 - 0.5 * pre.dR * dt2,
            bias=pre.bias, avg_a=pre.avg_a, avg_w=pre.avg_w,
        )
        # masked update: a padded sample leaves the state untouched
        ok1, ok3 = ok[..., None], ok[..., None, None]
        pre = Preintegrated(*(torch.where(ok if x.dim() == ok.dim() else
                                          ok1 if x.dim() == ok.dim() + 1 else ok3, x, y)
                              for x, y in zip(new[:10], pre[:10])), *pre[10:])
        sum_a = torch.where(ok1, sum_a + a, sum_a)
        sum_w = torch.where(ok1, sum_w + w, sum_w)
        n = torch.where(ok, n + 1.0, n)
    n = torch.clamp(n, min=1.0)[..., None]
    return pre._replace(avg_a=sum_a / n, avg_w=sum_w / n)


def rebias(pre: Preintegrated, bias: ImuBias) -> Preintegrated:
    """The interval moved to another linearization bias to first order
    (ORB-SLAM3's GetDeltaRotation / Velocity / Position(b) update,
    src/ImuTypes.cc:283-311, without the renormalization, so a zero change
    leaves the deltas exact); jacobians and covariance are kept."""
    dbg = bias.bg - pre.bias.bg
    dba = bias.ba - pre.bias.ba
    return pre._replace(
        dR=pre.dR @ so3.exp(_mv(pre.JRg, dbg)),
        dV=pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba),
        dP=pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba),
        bias=bias,
    )


# ---- bias-corrected getters (src/ImuTypes.cc:283-311) ----

def delta_rotation(pre: Preintegrated, bias: ImuBias):
    db = bias.bg - pre.bias.bg
    return so3.normalize(pre.dR @ so3.exp(pre.JRg @ db))


def delta_velocity(pre: Preintegrated, bias: ImuBias):
    dbg = bias.bg - pre.bias.bg
    dba = bias.ba - pre.bias.ba
    return pre.dV + pre.JVg @ dbg + pre.JVa @ dba


def delta_position(pre: Preintegrated, bias: ImuBias):
    dbg = bias.bg - pre.bias.bg
    dba = bias.ba - pre.bias.ba
    return pre.dP + pre.JPg @ dbg + pre.JPa @ dba


def predict_state(R_wb, v_w, p_w, pre: Preintegrated, bias: ImuBias):
    """Dead-reckon the body state across the interval (PredictStateIMU,
    src/Tracking.cc:1741)."""
    dt = pre.dT
    g = gravity_vec(v_w)
    R_new = R_wb @ delta_rotation(pre, bias)
    v_new = v_w + g * dt + R_wb @ delta_velocity(pre, bias)
    p_new = p_w + v_w * dt + 0.5 * g * dt * dt + R_wb @ delta_position(pre, bias)
    return R_new, v_new, p_new


def merge(pre1: Preintegrated, pre2: Preintegrated) -> Preintegrated:
    """Concatenate two intervals with the same linearization bias
    (Preintegrated::MergePrevious, src/ImuTypes.cc:133, in the reference
    package's closed form: first-order jacobian composition, covariances
    added)."""
    dT = pre1.dT + pre2.dT
    hat_v2 = so3.hat(pre2.dV)
    hat_p2 = so3.hat(pre2.dP)
    w1 = pre1.dT / torch.clamp(dT, min=1e-9)
    return Preintegrated(
        dT=dT,
        dR=so3.normalize(pre1.dR @ pre2.dR),
        dV=pre1.dV + pre1.dR @ pre2.dV,
        dP=pre1.dP + pre1.dV * pre2.dT + pre1.dR @ pre2.dP,
        C=pre1.C + pre2.C,
        JRg=pre2.dR.T @ pre1.JRg + pre2.JRg,
        JVg=pre1.JVg + pre1.dR @ pre2.JVg - pre1.dR @ hat_v2 @ pre1.JRg,
        JVa=pre1.JVa + pre1.dR @ pre2.JVa,
        JPg=pre1.JPg + pre1.JVg * pre2.dT + pre1.dR @ pre2.JPg - pre1.dR @ hat_p2 @ pre1.JRg,
        JPa=pre1.JPa + pre1.JVa * pre2.dT + pre1.dR @ pre2.JPa,
        bias=pre1.bias,
        avg_a=w1 * pre1.avg_a + (1 - w1) * pre2.avg_a,
        avg_w=w1 * pre1.avg_w + (1 - w1) * pre2.avg_w,
    )
