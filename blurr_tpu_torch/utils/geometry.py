"""3-D rotation conversions (transforms3d-compatible subset).

The port's own copy of ``blurr_tpu/utils/geometry.py``, unchanged: the port
imports nothing of the JAX package, not even its numpy modules.
Quaternions are [w, x, y, z]; Euler angles use the 'sxyz' static-frame
convention, i.e. the rotation matrix is R = Rz(ak) @ Ry(aj) @ Rx(ai)
(extrinsic x, then y, then z). Pure numpy, host-side (these run in the env
adapters' pre/post-processing). ``tests/test_torch_eval_agent.py`` holds
every function equal to the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np

_EPS = np.finfo(np.float64).eps * 4.0


def euler2mat(ai: float, aj: float, ak: float) -> np.ndarray:
    """sxyz Euler angles -> 3x3 rotation matrix (R = Rz @ Ry @ Rx)."""
    si, ci = math.sin(ai), math.cos(ai)
    sj, cj = math.sin(aj), math.cos(aj)
    sk, ck = math.sin(ak), math.cos(ak)
    return np.array(
        [
            [ck * cj, -sk * ci + ck * sj * si, sk * si + ck * sj * ci],
            [sk * cj, ck * ci + sk * sj * si, -ck * si + sk * sj * ci],
            [-sj, cj * si, cj * ci],
        ]
    )


def mat2euler(mat: np.ndarray):
    """3x3 rotation matrix -> sxyz Euler angles (ai, aj, ak)."""
    m = np.asarray(mat, dtype=np.float64)
    cy = math.sqrt(m[0, 0] * m[0, 0] + m[1, 0] * m[1, 0])
    if cy > _EPS:
        ai = math.atan2(m[2, 1], m[2, 2])
        aj = math.atan2(-m[2, 0], cy)
        ak = math.atan2(m[1, 0], m[0, 0])
    else:  # gimbal lock: aj = +/- pi/2
        ai = math.atan2(-m[1, 2], m[1, 1])
        aj = math.atan2(-m[2, 0], cy)
        ak = 0.0
    return ai, aj, ak


def quat2mat(q) -> np.ndarray:
    """[w, x, y, z] quaternion -> 3x3 rotation matrix (non-unit safe)."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    nq = w * w + x * x + y * y + z * z
    if nq < _EPS:
        return np.eye(3)
    s = 2.0 / nq
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def mat2quat(mat: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> [w, x, y, z] (Shepperd's method)."""
    m = np.asarray(mat, dtype=np.float64)
    t = m.trace()
    if t > 0:
        r = math.sqrt(1.0 + t)
        w = 0.5 * r
        s = 0.5 / r
        x = (m[2, 1] - m[1, 2]) * s
        y = (m[0, 2] - m[2, 0]) * s
        z = (m[1, 0] - m[0, 1]) * s
    else:
        i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        r = math.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        v = [0.0, 0.0, 0.0]
        v[i] = 0.5 * r
        s = 0.5 / r
        w = (m[k, j] - m[j, k]) * s
        v[j] = (m[j, i] + m[i, j]) * s
        v[k] = (m[k, i] + m[i, k]) * s
        x, y, z = v
    q = np.array([w, x, y, z])
    if q[0] < 0:
        q = -q
    return q


def _qmul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def euler2quat(ai: float, aj: float, ak: float) -> np.ndarray:
    """sxyz Euler -> [w, x, y, z]: q = qz(ak) * qy(aj) * qx(ai)."""
    qx = np.array([math.cos(ai / 2), math.sin(ai / 2), 0.0, 0.0])
    qy = np.array([math.cos(aj / 2), 0.0, math.sin(aj / 2), 0.0])
    qz = np.array([math.cos(ak / 2), 0.0, 0.0, math.sin(ak / 2)])
    return _qmul(qz, _qmul(qy, qx))


def quat2euler(q):
    return mat2euler(quat2mat(q))


def quat2axangle(q):
    """[w, x, y, z] -> (unit axis, angle in [0, 2*pi))."""
    q = np.asarray(q, dtype=np.float64)
    norm = np.linalg.norm(q)
    if norm < _EPS:
        return np.array([1.0, 0.0, 0.0]), 0.0
    q = q / norm
    w = min(max(q[0], -1.0), 1.0)
    vnorm = np.linalg.norm(q[1:])
    if vnorm < _EPS:
        return np.array([1.0, 0.0, 0.0]), 0.0
    angle = 2.0 * math.atan2(vnorm, w)
    return q[1:] / vnorm, angle


def euler2axangle(ai: float, aj: float, ak: float):
    """sxyz Euler -> (axis, angle) (the adapters' action-rotation format)."""
    return quat2axangle(euler2quat(ai, aj, ak))
