"""Synthetic stereo(-inertial) scenes with exact ground truth (numpy only).

The port's own copy of ``make_scene`` and what it needs from
``vslam_tpu/utils/synthetic.py``: the same scenes, rendered frames, poses
and IMU samples from the same seed (tests/test_torch_geometry_ops.py holds
the two equal). A cloud of textured 3D landmarks is rendered into a moving
stereo rig; a smooth analytic trajectory provides exact poses and exact
IMU samples; ``make_loop_scene`` is the closed circuit of the loop-closure
tests and bench. Two maps are built directly, without tracking: the
corridor of the global-BA tests and the split map of the loop-closure
tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np


GRAVITY_W = np.array([0.0, 0.0, -9.81])


def _np_expmap(w: np.ndarray) -> np.ndarray:
    """Host-side Rodrigues (N, 3) -> (N, 3, 3). Scene construction calls
    this thousands of times for tiny arrays, so it stays in numpy."""
    w = np.atleast_2d(np.asarray(w, np.float64))
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    theta = np.maximum(theta, 1e-12)
    k = w / theta
    K = np.zeros((len(w), 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    st = np.sin(theta)[..., None]
    ct = np.cos(theta)[..., None]
    return np.eye(3) + st * K + (1.0 - ct) * (K @ K)


def _np_logmap(R: np.ndarray) -> np.ndarray:
    """Host-side SO(3) log (N, 3, 3) -> (N, 3) for small-to-moderate
    angles (the finite-difference gyro extraction uses eps-scale steps)."""
    R = np.asarray(R, np.float64)
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(tr)
    v = np.stack(
        [R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]],
        axis=-1,
    )
    s = np.where(theta > 1e-9, theta / np.maximum(2.0 * np.sin(theta), 1e-12), 0.5)
    return v * s[:, None]



def _smooth_trajectory(n_frames: int, dt: float, speed: float = 1.2, yaw_rate: float = 0.05):
    """Analytic c2w poses: forward motion along +z with gentle lateral sine
    and slow yaw. Returns (N,4,4) poses, plus callables p(t), R(t)."""

    def pos(t):
        return np.stack(
            [0.35 * np.sin(0.5 * t), 0.2 * np.sin(0.33 * t), speed * t], axis=-1
        )

    def rotvec(t):
        return np.stack(
            [0.03 * np.sin(0.4 * t), yaw_rate * t, 0.02 * np.sin(0.6 * t)], axis=-1
        )

    ts = np.arange(n_frames) * dt
    R = _np_expmap(rotvec(ts).reshape(-1, 3))
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = pos(ts)
    return ts, poses, pos, rotvec


def _make_patch(rng: np.random.Generator, size: int = 21) -> np.ndarray:
    """A high-contrast blob that triggers FAST and has a distinctive BRIEF
    signature: SMOOTH random texture (binary noise box-blurred once) with a
    bright core placed OFF-CENTER, so the intensity-centroid orientation is
    well-defined and stable across views. Smooth texture resamples stably
    under the perspective depth scaling in render()."""
    p = (rng.uniform(0.0, 1.0, size=(size + 2, size + 2)) > 0.5).astype(np.float32)
    # 3x3 box blur (keeps strong gradients but kills single-pixel aliasing)
    p = sum(
        p[dy : dy + size, dx : dx + size] for dy in range(3) for dx in range(3)
    ) / 9.0
    p = p * 190.0 + 30.0
    c = size // 2
    # off-center bright core: deterministic direction per patch
    oy, ox = rng.integers(-2, 3, size=2)
    p[c - 1 + oy : c + 2 + oy, c - 1 + ox : c + 2 + ox] = 250.0
    p[c, c] = 240.0
    return p.astype(np.float32)


@dataclasses.dataclass
class SyntheticScene:
    width: int
    height: int
    K: np.ndarray  # (3,3)
    baseline: float
    points_w: np.ndarray  # (P, 3)
    patches: np.ndarray  # (P, S, S)
    times: np.ndarray  # (N,)
    poses_c2w: np.ndarray  # (N, 4, 4) left-camera-to-world
    velocities: np.ndarray  # (N, 3) exact world-frame velocity at frame times
    imu: np.ndarray  # (M, 7) [t, gyro, accel] exact body-frame samples
    imu_hz: float

    # physical FULL width of a patch in meters. Each patch is a textured 3D
    # plane with FIXED world orientation (facing -z, the camera's initial
    # viewing direction, unless patch_R gives a per-patch frame), rendered
    # by exact per-pixel ray-plane intersection (a homography). Every
    # texture element — hence every FAST corner the extractor finds on it —
    # is a static 3D point observed consistently (subpixel) across all
    # views, like a real rigid scene. (Earlier image-space splatting
    # re-aligned the texture to each view's pixel grid, which made
    # off-center corners MOVE in 3D as the camera yawed, and
    # integer-rounded centers injected +-0.5 px per-frame jitter
    # = 0.2-1.8 m of stereo depth noise at z=5-10 m.)
    patch_phys: float = 0.35

    # background gray level. The straight-line scenes keep the legacy
    # dark background (the strong patch-vs-background edges give the
    # dense generic corners their tracking tests were gated on); circuit
    # scenes use a mid-gray background matched to the texture mean —
    # otherwise every patch boundary/coarse-octave keypoint is the same
    # "bright square on dark" signature and global descriptor retrieval
    # aliases catastrophically (measured: 90% of keys match below the
    # retrieval threshold in a view with ZERO overlap; mid-gray drops
    # that to ~5%).
    background: float = 15.0

    # optional per-patch orientation: (P, 3, 3) world frames whose columns
    # are (e_x, e_y, normal). None = every patch faces -z (the straight-
    # line scenes). Circuit scenes (make_loop_scene) use this to build a
    # cylindrical wall of inward-facing patches, so a camera driving a
    # full loop always has well-conditioned texture in view.
    patch_R: np.ndarray | None = None

    # --- hard mode (VERDICT round-1 #6: the bench scene was "easier than
    # the target"): photometric sensor noise, exposure drift, and STATIC
    # world-anchored foreground occluders that hide landmarks as the
    # camera moves past them (the camera's own motion sweeps them across
    # the image; they are real static geometry, so occlusion robustness is
    # tested without violating the static-scene assumption the reference
    # also makes — it has no dynamic-object handling either). All
    # deterministic per (frame, eye) so runs are repeatable. ---
    noise_std: float = 0.0  # additive Gaussian pixel noise sigma
    gain_drift: float = 0.0  # multiplicative exposure oscillation amplitude
    occluders_w: np.ndarray | None = None  # (O, 3) world centers of static
    #   textureless planes (normal -z), set by make_scene(n_occluders=...)
    occluder_half: float = 0.25  # half-extent (m) of each occluder plane

    def _apply_hard_mode(self, img: np.ndarray, frame: int, right: bool) -> np.ndarray:
        W, H = self.width, self.height
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx0, cy0 = self.K[0, 2], self.K[1, 2]
        if self.occluders_w is not None and len(self.occluders_w):
            T_wc = self.poses_c2w[frame].copy()
            if right:
                T_wc[:3, 3] += T_wc[:3, :3] @ np.array([self.baseline, 0, 0])
            T_cw = np.linalg.inv(T_wc)
            pc = (T_cw[:3, :3] @ self.occluders_w.T).T + T_cw[:3, 3]
            for k in range(len(pc)):
                z = pc[k, 2]
                if z < 0.4:
                    continue  # camera has passed this occluder
                u = fx * pc[k, 0] / z + cx0
                v = fy * pc[k, 1] / z + cy0
                hw = fx * self.occluder_half / z
                hh = fy * self.occluder_half / z
                x0c, x1c = max(int(u - hw), 0), min(int(u + hw), W)
                y0c, y1c = max(int(v - hh), 0), min(int(v + hh), H)
                if x0c < x1c and y0c < y1c:
                    # smooth gradient fill: edges but no corner texture
                    gx = np.linspace(60.0, 110.0 + 15.0 * k, x1c - x0c)[None, :]
                    img[y0c:y1c, x0c:x1c] = gx
        if self.gain_drift:
            gain = 1.0 + self.gain_drift * np.sin(0.7 * frame + (0.5 if right else 0.0))
            img = img * gain + 6.0 * np.sin(1.3 * frame)
        if self.noise_std:
            rng = np.random.default_rng(7919 * frame + (997 if right else 0))
            img = img + rng.normal(0.0, self.noise_std, img.shape)
        return np.clip(img, 0.0, 255.0).astype(np.float32)

    def render(self, frame: int, right: bool = False) -> np.ndarray:
        """Render one grayscale view: per-pixel ray / patch-plane
        intersection with bilinear texture sampling. Painter order (far
        first) resolves occlusion."""
        T_wc = self.poses_c2w[frame].copy()
        if right:
            T_wc[:3, 3] += T_wc[:3, :3] @ np.array([self.baseline, 0, 0])
        R_wc = T_wc[:3, :3]
        o_w = T_wc[:3, 3]
        T_cw = np.linalg.inv(T_wc)
        pc = (T_cw[:3, :3] @ self.points_w.T).T + T_cw[:3, 3]
        z = pc[:, 2]
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        u = fx * pc[:, 0] / np.maximum(z, 1e-6) + cx
        v = fy * pc[:, 1] / np.maximum(z, 1e-6) + cy
        img = np.full((self.height, self.width), self.background, dtype=np.float32)
        S = self.patches.shape[1]
        W, H = self.width, self.height
        half = 0.5 * self.patch_phys
        # patch plane basis, fixed in world: per-patch (e_x, e_y, n) from
        # patch_R, defaulting to e_x = +x, e_y = +y, normal -z
        order = np.argsort(-z)  # far first
        for i in order:
            if z[i] < 0.3:
                continue
            c_w = self.points_w[i]
            if self.patch_R is not None:
                e_x, e_y, nrm = self.patch_R[i].T
            else:
                e_x = np.array([1.0, 0.0, 0.0])
                e_y = np.array([0.0, 1.0, 0.0])
                nrm = np.array([0.0, 0.0, -1.0])
            # backface / grazing cull: camera must be on the normal side
            view = c_w - o_w
            if np.dot(view, nrm) > -0.15 * np.linalg.norm(view):
                continue
            # exact bounding box: project the 4 physical corners
            corners = c_w + half * (
                np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]], np.float32)
                @ np.stack([e_x, e_y])
            )
            cc = (T_cw[:3, :3] @ corners.T).T + T_cw[:3, 3]
            if (cc[:, 2] < 0.25).any():
                continue
            uc = fx * cc[:, 0] / cc[:, 2] + cx
            vc = fy * cc[:, 1] / cc[:, 2] + cy
            if uc.max() - uc.min() < 5 and vc.max() - vc.min() < 5:
                continue  # too small to carry texture
            x0 = max(int(np.floor(uc.min())) - 1, 0)
            x1 = min(int(np.ceil(uc.max())) + 2, W)
            y0 = max(int(np.floor(vc.min())) - 1, 0)
            y1 = min(int(np.ceil(vc.max())) + 2, H)
            if x0 >= x1 or y0 >= y1:
                continue
            xs = np.arange(x0, x1, dtype=np.float32)
            ys = np.arange(y0, y1, dtype=np.float32)
            gx, gy = np.meshgrid(xs, ys)
            # world ray through each pixel center
            d_c = np.stack(
                [(gx - cx) / fx, (gy - cy) / fy, np.ones_like(gx)], axis=-1
            )
            d_w = d_c @ R_wc.T  # (h, w, 3)
            # plane: n . (o + t d - c) = 0 -> t = n.(c - o) / n.d
            dn = d_w @ nrm
            t = np.dot(nrm, c_w - o_w) / np.where(np.abs(dn) < 1e-9, 1e-9, dn)
            p_w = o_w[None, None, :] + t[..., None] * d_w
            rel = p_w - c_w
            lx = (rel @ e_x) / half  # in-plane coords in [-1, 1]
            ly = (rel @ e_y) / half
            hit = (t > 0.3) & (np.abs(lx) <= 1.0) & (np.abs(ly) <= 1.0)
            if not hit.any():
                continue
            tx = np.clip((lx + 1.0) * 0.5 * (S - 1), 0, S - 1)
            ty = np.clip((ly + 1.0) * 0.5 * (S - 1), 0, S - 1)
            xi0 = np.floor(tx).astype(int)
            yi0 = np.floor(ty).astype(int)
            xi1 = np.minimum(xi0 + 1, S - 1)
            yi1 = np.minimum(yi0 + 1, S - 1)
            ax = (tx - xi0).astype(np.float32)
            ay = (ty - yi0).astype(np.float32)
            P = self.patches[i]
            val = (
                P[yi0, xi0] * (1 - ax) * (1 - ay)
                + P[yi0, xi1] * ax * (1 - ay)
                + P[yi1, xi0] * (1 - ax) * ay
                + P[yi1, xi1] * ax * ay
            )
            sub = img[y0:y1, x0:x1]
            img[y0:y1, x0:x1] = np.where(hit, val, sub)
        if self.noise_std or self.gain_drift or self.occluders_w is not None:
            img = self._apply_hard_mode(img, frame, right)
        return img

    def project_points(self, frame: int, right: bool = False):
        """Exact (P,2) pixel locations + (P,) validity + depth for oracle checks."""
        T_wc = self.poses_c2w[frame].copy()
        if right:
            T_wc[:3, 3] += T_wc[:3, :3] @ np.array([self.baseline, 0, 0])
        T_cw = np.linalg.inv(T_wc)
        pc = (T_cw[:3, :3] @ self.points_w.T).T + T_cw[:3, 3]
        z = pc[:, 2]
        u = self.K[0, 0] * pc[:, 0] / np.maximum(z, 1e-6) + self.K[0, 2]
        v = self.K[1, 1] * pc[:, 1] / np.maximum(z, 1e-6) + self.K[1, 2]
        S = self.patches.shape[1]
        h = S // 2 + 1
        valid = (z > 0.3) & (u >= h) & (u < self.width - h) & (v >= h) & (v < self.height - h)
        return np.stack([u, v], axis=-1), valid, z


def _make_patch_coarse(rng: np.random.Generator, size: int = 21) -> np.ndarray:
    """High-contrast COARSE blob texture (half-resolution noise,
    upsampled, thresholded at the median, then one box blur): every
    corner's BRIEF signature is determined by an independent random blob
    layout, so descriptors are near-iid ACROSS patches — the property
    global retrieval (reloc / loop closure) needs from a synthetic world.
    (_make_patch's smooth fine noise + off-center core reads as one
    shared "texture family" after orientation normalization: inter-patch
    Hamming clusters far below the matching threshold.) The final blur
    makes the hard blob edges resample smoothly under the renderer's
    bilinear warp — measured temporal match stability 0.43 -> 0.54 at
    the retrieval threshold with no change in the inter-patch alias rate
    (0.056)."""
    h = (size + 2) // 2 + 1
    n = rng.uniform(0.0, 1.0, size=(h, h))
    big = np.kron(n, np.ones((2, 2)))[: size + 2, : size + 2]
    pad = size + 2 - big.shape[0]
    if pad > 0:
        big = np.pad(big, ((0, pad), (0, pad)), mode="edge")
    p = (big > np.median(big)).astype(np.float32)
    q = sum(
        p[dy : dy + size, dx : dx + size] for dy in range(3) for dx in range(3)
    ) / 9.0
    return (q * 215.0 + 25.0).astype(np.float32)


def _make_patch_natural(rng: np.random.Generator, size: int = 21) -> np.ndarray:
    """1/f-amplitude (pink) spectral noise patch — NATURAL-image
    second-order statistics (power spectrum ~ 1/f^2). The blob textures'
    descriptor statistics are synthetic and unrepresentative; natural
    texture has long-range correlation,
    weaker local contrast, and corner responses that ride on smooth
    gradients — the regime real FAST/BRIEF operate in."""
    n = size + 2
    f = np.fft.fftfreq(n)
    fx, fy = np.meshgrid(f, f)
    rad = np.sqrt(fx * fx + fy * fy)
    rad[0, 0] = np.abs(f[1])
    amp = 1.0 / rad
    amp[0, 0] = 0.0  # zero mean; DC restored by the gray offset below
    phase = rng.uniform(0.0, 2.0 * np.pi, (n, n))
    img = np.real(np.fft.ifft2(amp * np.exp(1j * phase)))
    img = img[1 : size + 1, 1 : size + 1]
    lo, hi = img.min(), img.max()
    img = (img - lo) / max(hi - lo, 1e-9)
    return (img * 205.0 + 25.0).astype(np.float32)


def _repeated_patch_bank(
    rng: np.random.Generator, n_points: int, n_distinct: int = 8
) -> np.ndarray:
    """REPEATED-STRUCTURE texture: only `n_distinct` base patches tiled
    across all landmarks (a building facade's identical windows). Every
    descriptor has dozens of near-exact aliases in the map — the
    worst case for wide-radius matching, retrieval and loop-closure
    verification; the ratio tests and contiguity gates must carry it."""
    bank = np.stack([_make_patch_coarse(rng) for _ in range(n_distinct)])
    return bank[np.arange(n_points) % n_distinct]


def _imu_from_analytic(n_frames, dt, imu_hz, pos_fn, rotvec_fn):
    """Exact IMU samples: finite-difference the analytic trajectory at
    high rate. Returns (M, 7) [t, gyro_xyz, accel_xyz] body-frame rows."""
    m = int(n_frames * dt * imu_hz)
    t_imu = (np.arange(m) + 1) * (1.0 / imu_hz)
    eps = 1e-4

    def R_of(t):
        return _np_expmap(rotvec_fn(np.atleast_1d(t)).reshape(-1, 3))

    R_t = R_of(t_imu)
    R_tp = R_of(t_imu + eps)
    dR = np.einsum("nij,nik->njk", R_t, R_tp)  # R^T R+
    gyro = _np_logmap(dR) / eps
    acc_w = (
        pos_fn(t_imu + eps) - 2.0 * pos_fn(t_imu) + pos_fn(t_imu - eps)
    ) / eps**2
    spec_force_w = acc_w - GRAVITY_W
    accel = np.einsum("nji,nj->ni", R_t, spec_force_w)  # body frame: R^T f_w
    return np.concatenate([t_imu[:, None], gyro, accel], axis=1)


def make_scene(
    n_frames: int = 30,
    n_points: int = 400,
    width: int = 640,
    height: int = 480,
    fps: float = 10.0,
    imu_hz: float = 200.0,
    seed: int = 0,
    depth_range: tuple | None = None,
    noise_std: float = 0.0,
    gain_drift: float = 0.0,
    n_occluders: int = 0,
    lowtex_span: tuple | None = None,
    texture: str = "classic",
    motion: str = "forward",
    ramp_tau: float | None = None,
    speed: float = 1.2,
    yaw_rate: float = 0.05,
) -> SyntheticScene:
    """`lowtex_span=(z0, z1, keep)`: a LOW-TEXTURE stretch — inside the
    world-z band [z0, z1] only a `keep` fraction of landmarks survive, so
    the camera drives through a feature desert (blank corridor wall) for
    (z1-z0)/speed seconds. Exercises the failure gate, outlier aging and
    re-acquisition on the far side — robustness the reference lacks
    entirely (SURVEY.md §5 failure-detection row).

    `ramp_tau` (seconds): start from REST with an analytic velocity
    ramp — the trajectory is time-warped by s(t) = t - tau + tau e^{-t/tau}
    (s'(0)=0, s'(inf)=1), so every velocity component including angular
    rate begins at zero, exactly like a real capture (the EuRoC MAV sits
    on the ground before takeoff). Without it a tracker initialized at
    v=0 fights an instant full-speed IMU mismatch it can never have on
    real data.

    `motion="forward"` is the original driving trajectory (+z dominant).
    `motion="lateral"` strafes sideways with slow forward drift and a
    small yaw oscillation — the EuRoC-drone-like regime MONOCULAR
    initialization needs: lateral baseline gives every landmark real
    parallax, and the wall of points stays in view instead of being
    outrun (forward motion gives near-zero parallax at the image center
    and flies past every close landmark within a few frames).

    `texture="classic"` keeps the original smooth-noise patches on a dark
    background (most tracking-test gates were tuned on it).
    `texture="distinct"` uses the coarse iid-blob patches on a mid-gray
    background (_make_patch_coarse): inter-patch BRIEF descriptors are
    near-iid, which global retrieval AND wide-search matching need —
    measured on "classic", 90% of keys Hamming-match below the retrieval
    threshold in a view with ZERO overlap, which floods ratio tests and
    wide-radius mono matching with aliases."""
    rng = np.random.default_rng(seed)
    dt = 1.0 / fps
    if motion in ("lateral", "excited"):
        speed_x, speed_z = 0.6, 0.12
        # "excited": lateral sweep with STRONG velocity oscillation.
        # Monocular-inertial SCALE is observable only under acceleration
        # (a constant velocity error is invisible to the accelerometer,
        # so under near-constant motion mono scale + velocity drift
        # together — measured: the plain lateral sweep diverges ~1 cm/
        # frame after ~100 frames with healthy inlier counts). Real MAV
        # sequences are acceleration-rich; this variant matches that
        # regime: +-0.45 m/s velocity swing at ~0.4 m/s^2 peak.
        amp = 0.5 if motion == "excited" else 0.0

        def pos_fn(t):
            t = np.asarray(t, np.float64)
            return np.stack(
                [
                    speed_x * t + amp * np.sin(0.9 * t),
                    0.12 * np.sin(0.4 * t) + 0.3 * amp * np.sin(1.3 * t),
                    speed_z * t,
                ],
                axis=-1,
            )

        def rotvec_fn(t):
            t = np.asarray(t, np.float64)
            return np.stack(
                [0.02 * np.sin(0.35 * t), 0.06 * np.sin(0.25 * t),
                 0.015 * np.sin(0.5 * t)], axis=-1,
            )

        ts = np.arange(n_frames) * dt
        R = _np_expmap(rotvec_fn(ts).reshape(-1, 3))
        poses = np.tile(np.eye(4), (n_frames, 1, 1))
        poses[:, :3, :3] = R
        poses[:, :3, 3] = pos_fn(ts)
    else:
        # yaw_rate matters on LONG sequences: the forward scene's patches
        # face -z, so total yaw must stay well under ~45 deg or the wall
        # turns edge-on and texture degenerates (a 1000-frame run at the
        # old fixed 0.05 rad/s accumulated 143 deg and drift x20'd)
        ts, poses, pos_fn, rotvec_fn = _smooth_trajectory(
            n_frames, dt, speed=speed, yaw_rate=yaw_rate
        )

    if ramp_tau is not None:
        tau = float(ramp_tau)
        base_pos, base_rot = pos_fn, rotvec_fn

        def _warp(t):
            t = np.asarray(t, np.float64)
            return t - tau + tau * np.exp(-np.maximum(t, 0.0) / tau)

        def pos_fn(t):
            return base_pos(_warp(t))

        def rotvec_fn(t):
            return base_rot(_warp(t))

        R = _np_expmap(rotvec_fn(ts).reshape(-1, 3))
        poses = np.tile(np.eye(4), (n_frames, 1, 1))
        poses[:, :3, :3] = R
        poses[:, :3, 3] = pos_fn(ts)

    K = np.array([[460.0, 0, width / 2.0], [0, 460.0, height / 2.0], [0, 0, 1.0]])
    baseline = 0.12

    if motion in ("lateral", "excited"):
        # a wall of landmarks spanning the lateral sweep
        span = 0.6 * n_frames * dt
        zmin, zmax = depth_range if depth_range else (3.0, 9.0)
        pts = np.stack(
            [
                rng.uniform(-3.0, span + 3.0, n_points),
                rng.uniform(-2.5, 2.5, n_points),
                rng.uniform(zmin, zmax, n_points),
            ],
            axis=-1,
        )
    else:
        # landmarks in a slab in front of the whole trajectory
        total_len = 1.2 * n_frames * dt
        zmin, zmax = depth_range if depth_range else (1.5, total_len + 14.0)
        pts = np.stack(
            [
                rng.uniform(-6.0, 6.0, n_points),
                rng.uniform(-4.0, 4.0, n_points),
                rng.uniform(zmin, zmax, n_points),
            ],
            axis=-1,
        )
    if lowtex_span is not None:
        z0, z1, keep = lowtex_span
        inside = (pts[:, 2] >= z0) & (pts[:, 2] <= z1)
        drop = inside & (rng.uniform(0.0, 1.0, n_points) > keep)
        pts = pts[~drop]
        n_points = len(pts)
    if texture == "repeated":
        patches = _repeated_patch_bank(rng, n_points)
    else:
        patch_fn = {
            "distinct": _make_patch_coarse,
            "natural": _make_patch_natural,
        }.get(texture, _make_patch)
        patches = np.stack([patch_fn(rng) for _ in range(n_points)])

    # static world-anchored occluder planes, staggered along (and slightly
    # off) the camera path so forward motion sweeps them across the view
    occluders_w = None
    if n_occluders:
        occluders_w = np.stack(
            [
                np.array([
                    (-1.0) ** k * (0.55 + 0.2 * k),
                    0.25 * np.sin(1.7 * k),
                    2.5 + (total_len + 4.0) * k / n_occluders,
                ])
                for k in range(n_occluders)
            ]
        )

    imu = _imu_from_analytic(n_frames, dt, imu_hz, pos_fn, rotvec_fn)
    eps = 1e-4
    vel = (pos_fn(ts + eps) - pos_fn(ts - eps)) / (2 * eps)

    return SyntheticScene(
        width=width,
        height=height,
        K=K,
        baseline=baseline,
        points_w=pts,
        patches=patches,
        times=ts,
        poses_c2w=poses,
        velocities=vel,
        imu=imu,
        imu_hz=imu_hz,
        background=15.0 if texture == "classic" else 120.0,
        noise_std=noise_std,
        gain_drift=gain_drift,
        occluders_w=occluders_w,
    )


def make_loop_scene(
    n_frames: int = 325,
    n_points: int = 700,
    width: int = 512,
    height: int = 384,
    fps: float = 10.0,
    imu_hz: float = 200.0,
    seed: int = 0,
    radius: float = 6.0,
    wall_radius: float = 10.0,
    loops: float = 1.1,
    noise_std: float = 0.0,
    gain_drift: float = 0.0,
) -> SyntheticScene:
    """A CLOSED-CIRCUIT scene for end-to-end loop-closure validation: the
    camera drives `loops` revolutions of a circle (radius m) inside a
    cylindrical wall of inward-facing textured patches, returning to its
    start pose with the same heading — the canonical revisit geometry.
    Pure yaw accumulates heading drift that compounds into position error
    over the lap, which a verified loop edge + pose graph must remove
    (the reference's loop-closure state is vestigial, Map.h:122-127 —
    this scene validates the real detector against live tracker output).

    Geometry: camera at C + radius*(-cos wt, y_wobble, sin wt) heading
    tangentially (yaw = wt); wall patches at angle phi on radii around
    `wall_radius` with normals pointing at C, so the visible arc
    (phi - yaw in ~[30, 90] deg) is always seen at benign (<40 deg)
    incidence and 5-11 m depth, uniformly over the whole lap."""
    rng = np.random.default_rng(seed)
    dt = 1.0 / fps
    omega = 2.0 * np.pi * loops / (n_frames * dt)
    C = np.array([radius, 0.0, 0.0])

    def pos(t):
        t = np.asarray(t, np.float64)
        th = omega * t
        return np.stack(
            [
                C[0] - radius * np.cos(th),
                0.15 * np.sin(0.4 * t),
                radius * np.sin(th),
            ],
            axis=-1,
        )

    def rotvec(t):
        t = np.asarray(t, np.float64)
        return np.stack(
            [np.zeros_like(t), omega * t, np.zeros_like(t)], axis=-1
        )

    ts = np.arange(n_frames) * dt
    R = _np_expmap(rotvec(ts).reshape(-1, 3))
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = pos(ts)

    K = np.array(
        [[460.0, 0, width / 2.0], [0, 460.0, height / 2.0], [0, 0, 1.0]]
    )
    baseline = 0.12

    # cylindrical wall: angles uniform over the lap, jittered radius/height
    phi = rng.uniform(0.0, 2.0 * np.pi, n_points)
    r_k = rng.uniform(0.85 * wall_radius, 1.15 * wall_radius, n_points)
    h_k = rng.uniform(-2.4, 2.4, n_points)
    pts = np.stack(
        [C[0] - r_k * np.cos(phi), h_k, r_k * np.sin(phi)], axis=-1
    )
    # inward patch frames: normal points at the circuit axis
    nrm = np.stack([np.cos(phi), np.zeros_like(phi), -np.sin(phi)], axis=-1)
    e_y = np.tile(np.array([0.0, 1.0, 0.0]), (n_points, 1))
    e_x = np.stack([-np.sin(phi), np.zeros_like(phi), -np.cos(phi)], axis=-1)
    patch_R = np.stack([e_x, e_y, nrm], axis=-1).astype(np.float64)
    patches = np.stack([_make_patch_coarse(rng) for _ in range(n_points)])

    imu = _imu_from_analytic(n_frames, dt, imu_hz, pos, rotvec)
    eps = 1e-4
    vel = (pos(ts + eps) - pos(ts - eps)) / (2 * eps)

    return SyntheticScene(
        width=width,
        height=height,
        K=K,
        baseline=baseline,
        points_w=pts,
        patches=patches,
        times=ts,
        poses_c2w=poses,
        velocities=vel,
        imu=imu,
        imu_hz=imu_hz,
        patch_R=patch_R,
        patch_phys=0.5,
        background=120.0,
        noise_std=noise_std,
        gain_drift=gain_drift,
    )


def corridor_map(
    n_kf: int, n_lm: int, keys_per_kf: int, obs_per_lm: int = 3, seed: int = 0,
    fx: float = 460.0, cx: float = 320.0, cy: float = 240.0, baseline: float = 0.12,
) -> dict:
    """A map-scale keyframe map built directly, without tracking (the copy
    of tests/test_ba.py:150-228's world): keyframe poses along a forward
    corridor with a slow yaw, landmarks spread along it, each observed by
    `obs_per_lm` consecutive keyframes with exact stereo projections (the
    first `keys_per_kf` that fit a keyframe). Returns numpy arrays: poses
    (n_kf, 4, 4), pts (n_lm, 3), obs_uv (n_kf, K, 3), obs_lm (n_kf, K)
    int64 (-1 free), obs_oct, obs_stereo, obs_valid, lm_capacity (the
    power of two above n_lm + 1), and the rig's K and baseline."""
    rng = np.random.default_rng(seed)
    lm_cap = 1
    while lm_cap < n_lm + 2:
        lm_cap *= 2
    poses = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    for i in range(n_kf):
        yaw = 0.002 * i
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        poses[i, :3, 3] = [0.3 * np.sin(0.05 * i), 0.0, 0.5 * i]
    pts = np.stack(
        [rng.uniform(-6, 6, n_lm), rng.uniform(-4, 4, n_lm), rng.uniform(0, 0.5 * n_kf + 20.0, n_lm) + 6.0],
        axis=-1,
    ).astype(np.float32)
    K = keys_per_kf
    obs_uv = np.zeros((n_kf, K, 3), np.float32)
    obs_lm = np.full((n_kf, K), -1, np.int64)
    obs_valid = np.zeros((n_kf, K), bool)
    fill = np.zeros(n_kf, np.int64)
    T_cw = np.linalg.inv(poses)
    anchor = np.clip(((pts[:, 2] - 12.0) / 0.5).astype(np.int64), 0, n_kf - obs_per_lm)
    for i in range(n_lm):
        for d in range(obs_per_lm):
            k = int(anchor[i]) + d
            j = fill[k]
            if j >= K:
                continue
            pc = T_cw[k, :3, :3] @ pts[i] + T_cw[k, :3, 3]
            if pc[2] < 0.5:
                continue
            obs_uv[k, j] = [fx * pc[0] / pc[2] + cx, fx * pc[1] / pc[2] + cy,
                            fx * (pc[0] - baseline) / pc[2] + cx]
            obs_lm[k, j] = i
            obs_valid[k, j] = True
            fill[k] += 1
    return {
        "poses": poses, "pts": pts, "obs_uv": obs_uv, "obs_lm": obs_lm,
        "obs_oct": np.zeros((n_kf, K), np.int64), "obs_stereo": obs_valid.copy(),
        "obs_valid": obs_valid, "lm_capacity": lm_cap,
        "K": np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]], np.float32), "baseline": baseline,
    }


def corridor_world(n_kf: int, n_lm: int, keys_per_kf: int, *, device, **kw):
    """:func:`corridor_map` loaded into a WorldMap on `device` (8
    right-camera slots per keyframe, none used), host mirrors included.
    Returns (world, the corridor_map dict)."""
    import torch

    from vslam_torch.models import map_state

    c = corridor_map(n_kf, n_lm, keys_per_kf, **kw)
    world = map_state.WorldMap(lm_capacity=c["lm_capacity"], kf_capacity=n_kf,
                               keys_per_kf=keys_per_kf, right_obs_per_kf=8, device=device)
    m = world.arrays

    def put(name, a):
        getattr(m, name).copy_(torch.as_tensor(a))

    for name in ("obs_uv", "obs_lm", "obs_oct", "obs_stereo", "obs_valid"):
        put(name, c[name])
    put("kf_pose", c["poses"])
    m.kf_valid.fill_(True)
    m.lm_pos[:n_lm] = torch.as_tensor(c["pts"]).to(device)
    m.lm_valid[:n_lm] = True
    world.kf_obs_lm[:] = c["obs_lm"]
    world.kf_poses_host[:] = c["poses"]
    world.n_keyframes, world.n_landmarks = n_kf, n_lm
    world.kf_frame_idx[:n_kf] = np.arange(n_kf)
    return world, c


def split_map_world(n_kf: int = 20, n_pts: int = 400, seed: int = 3, scale_err: float = 1.0,
                    *, device):
    """The loop-closure tests' split map (the copy of
    tests/test_loop_closure.py:276-370's world), built without tracking: a
    trajectory that revisits its start, stored as two legs. Leg A
    (keyframes 0 .. n_kf/2 - 1) is the ground truth; leg B is stored
    behind a rigid drift T_err (and, for mono, a similarity scale
    `scale_err` about the origin) and re-observes leg A's points under
    duplicate landmark ids at the drifted positions. Every stored quantity
    is self-consistent, so only a loop closure can find the offset.
    Returns (WorldMap on `device`, true poses (n_kf, 4, 4), T_err, K)."""
    import torch

    from vslam_torch.geometry import se3
    from vslam_torch.models import map_state
    from vslam_torch.ops import hamming

    rng = np.random.default_rng(seed)
    K = np.array([[460.0, 0, 160.0], [0, 460.0, 120.0], [0, 0, 1.0]], np.float32)
    X = np.stack(
        [rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts), rng.uniform(5, 11, n_pts)], -1
    ).astype(np.float32)
    desc = (rng.integers(0, 2, (n_pts, 256)) * 2 - 1).astype(np.int8)

    half = n_kf // 2
    true_poses = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    zmax = 2.0
    for i in range(n_kf):
        if i < half:
            true_poses[i, :3, 3] = [0.0, 0.0, zmax * i / (half - 1)]
        else:
            true_poses[i, :3, 3] = [0.25, 0.0, zmax * (1.0 - (i - half) / (n_kf - half))]
    xi = np.array([0.06, 0.22, 0.08, 0.015, 0.03, 0.01], np.float32)
    T_err = se3.se3_expmap(torch.from_numpy(xi)).numpy()  # the drift

    W, keys_per_kf, P = 32, 512, 2048
    world = map_state.WorldMap(lm_capacity=P, kf_capacity=W, keys_per_kf=keys_per_kf,
                               right_obs_per_kf=8, device=device)
    # duplicate populations: leg A ids 0 .. n_pts-1 at X, leg B ids
    # n_pts .. 2 n_pts-1 at the drifted positions
    XB = scale_err * ((T_err[:3, :3] @ X.T).T + T_err[:3, 3])
    lm_pos = np.zeros((P, 3), np.float32)
    lm_pos[:n_pts] = X
    lm_pos[n_pts : 2 * n_pts] = XB
    lm_desc = np.zeros((P, 256), np.int8)
    lm_desc[:n_pts] = desc
    lm_desc[n_pts : 2 * n_pts] = desc
    lm_valid = np.zeros(P, bool)
    lm_valid[: 2 * n_pts] = True

    stored = true_poses.copy()
    stored[half:] = np.einsum("ij,kjl->kil", T_err, true_poses[half:])
    stored[half:, :3, 3] *= scale_err  # similarity: t' = s (R t + t_err)

    obs_uv = np.zeros((W, keys_per_kf, 3), np.float32)
    obs_lm = np.full((W, keys_per_kf), -1, np.int64)
    obs_desc = np.zeros((W, keys_per_kf, 256), np.int8)
    obs_valid = np.zeros((W, keys_per_kf), bool)
    for i in range(n_kf):
        T_cw = np.linalg.inv(true_poses[i])
        pc = (T_cw[:3, :3] @ X.T).T + T_cw[:3, 3]
        u = K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2]
        v = K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]
        vis = (pc[:, 2] > 1.0) & (u > 5) & (u < 315) & (v > 5) & (v < 235)
        idx = np.nonzero(vis)[0][:keys_per_kf]
        base = 0 if i < half else n_pts
        obs_uv[i, : len(idx), 0] = u[idx]
        obs_uv[i, : len(idx), 1] = v[idx]
        obs_lm[i, : len(idx)] = base + idx
        obs_desc[i, : len(idx)] = desc[idx]
        obs_valid[i, : len(idx)] = True

    kf_pose = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    kf_pose[:n_kf] = stored
    m = world.arrays
    for name, a in (("kf_pose", kf_pose), ("kf_valid", np.arange(W) < n_kf), ("lm_pos", lm_pos),
                    ("lm_desc", lm_desc), ("lm_valid", lm_valid), ("obs_uv", obs_uv),
                    ("obs_lm", obs_lm), ("obs_valid", obs_valid)):
        getattr(m, name).copy_(torch.from_numpy(a))
    m.obs_desc.copy_(hamming.pack_signed(torch.from_numpy(obs_desc)))
    world.kf_poses_host[:] = kf_pose
    world.kf_obs_lm[:] = obs_lm
    world.n_keyframes = n_kf
    world.n_landmarks = 2 * n_pts
    world.kf_frame_idx[:n_kf] = np.arange(n_kf)
    return world, true_poses, T_err, K
