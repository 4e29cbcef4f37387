"""The benchmark's scene generator: a frozen copy of the port's synthetic
stereo(-inertial) scenes, so that later changes to the program cannot move
the yardstick.

Copied from ``vslam_torch/utils/synthetic.py`` at commit
2160959f63e564fa020adbc072b172400944d475: ``_np_expmap``, ``_np_logmap``,
``_make_patch``, ``SyntheticScene`` (the renderer), ``_make_patch_coarse``
and ``_imu_from_analytic``, unchanged. New here: :func:`make_sequence`, which
builds a scene from a configuration's rig (its rectified intrinsics,
baseline, size and frame rate) and a traffic file's motion and landmark
layout, where the copied ``make_scene`` fixed the rig (fx 460, baseline
0.12 m) and the trajectory's shape.
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


# ---------------------------------------------------------------------------
# The benchmark's sequences: a configuration's rig under a traffic file's
# motion and landmark layout.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rig:
    """The stereo rig a configuration states: rectified left intrinsics, the
    baseline (the right camera sits at +baseline along x), the image size,
    the frame rate and the IMU rate."""

    width: int
    height: int
    K: tuple  # (fx, fy, cx, cy)
    baseline: float
    fps: float
    imu_hz: float
    # the IMU's noise as the configuration states it (None: no IMU block):
    # (gyro noise density, gyro random walk, accel noise density, accel
    # random walk), in rad/s/sqrt(Hz), rad/s^2/sqrt(Hz), m/s^2/sqrt(Hz),
    # m/s^3/sqrt(Hz)
    imu_noise: tuple | None = None

    @classmethod
    def from_system(cls, system: dict) -> "Rig":
        cam, left = system["Camera"], system["Camera_l"]
        if "P" in left:  # an unrectified rig's rectified intrinsics
            P = np.asarray(left["P"]["data"], np.float64).reshape(3, 4)
            K = (P[0, 0], P[1, 1], P[0, 2], P[1, 2])
        else:
            K = (left["fx"], left["fy"], left["cx"], left["cy"])
        imu = system.get("IMU")
        noise = None
        if imu is not None:
            noise = tuple(float(imu[k]) for k in (
                "gyroscope_noise_density", "gyroscope_random_walk",
                "accelerometer_noise_density", "accelerometer_random_walk"))
        return cls(
            width=int(cam["width"]), height=int(cam["height"]),
            K=tuple(float(k) for k in K), baseline=float(cam["bl"]),
            fps=float(cam["fps"]), imu_hz=float((imu or {}).get("Hz", 200.0)), imu_noise=noise,
        )


def motion_fns(motion: dict):
    """Analytic position and rotation vector of the left camera (world =
    the camera's start, looking along +z): a constant velocity plus a sine
    sway per axis, a sine rotation per axis plus a steady yaw, time-warped
    to start from rest when ``ramp_tau`` is given (make_scene's ramp)."""
    vel = np.asarray(motion["velocity"], np.float64)
    s_amp = np.asarray(motion["sway_amp"], np.float64)
    s_frq = np.asarray(motion["sway_freq"], np.float64)
    r_amp = np.asarray(motion["rot_amp"], np.float64)
    r_frq = np.asarray(motion["rot_freq"], np.float64)
    yaw = float(motion.get("yaw_rate", 0.0))
    tau = motion.get("ramp_tau")

    def warp(t):
        t = np.asarray(t, np.float64)
        if tau is None:
            return t
        return t - tau + tau * np.exp(-np.maximum(t, 0.0) / tau)

    def pos(t):
        s = warp(t)[..., None]
        return vel * s + s_amp * np.sin(s_frq * s)

    def rotvec(t):
        s = warp(t)[..., None]
        r = r_amp * np.sin(r_frq * s)
        r[..., 1] += yaw * s[..., 0]
        return r

    return pos, rotvec


def _landmarks(rng: np.random.Generator, layout: dict, travel_z: float) -> np.ndarray:
    """Patch centres in a slab in front of the whole path, none inside the
    corridor ``clear`` = (half-width in x, half-height in y) around it."""
    n = int(layout["count"])
    x0, x1 = layout["x"]
    y0, y1 = layout["y"]
    z0, z1 = float(layout["z_near"]), travel_z + float(layout["z_beyond"])
    cx, cy = layout.get("clear", (0.0, 0.0))
    pts = np.zeros((0, 3))
    while len(pts) < n:
        cand = np.stack(
            [rng.uniform(x0, x1, n), rng.uniform(y0, y1, n), rng.uniform(z0, z1, n)], axis=-1
        )
        keep = (np.abs(cand[:, 0]) >= cx) | (np.abs(cand[:, 1]) >= cy)
        pts = np.concatenate([pts, cand[keep]])
    return pts[:n]


def _add_imu_noise(rng, imu, hz, gyro_n, gyro_w, accel_n, accel_w):
    """The exact samples plus a sensor's errors at the stated densities:
    white noise (density * sqrt(Hz)) and a bias that random-walks from
    zero (walk * sqrt(dt) a sample), on each axis of gyro and accel."""
    m, dt = len(imu), 1.0 / hz
    out = imu.copy()
    for cols, n, w in ((slice(1, 4), gyro_n, gyro_w), (slice(4, 7), accel_n, accel_w)):
        bias = np.cumsum(rng.normal(0.0, w * np.sqrt(dt), (m, 3)), axis=0)
        out[:, cols] += rng.normal(0.0, n * np.sqrt(hz), (m, 3)) + bias
    return out


def make_sequence(rig: Rig, traffic: dict, seed: int) -> SyntheticScene:
    """The scene of one run: ``traffic["frames"]`` frames at the rig's rate
    along the traffic's motion, its landmarks and textures drawn from
    `seed`. The trajectory is the traffic's alone; the seed changes only
    where the landmarks are and what they look like."""
    rng = np.random.default_rng(seed % 2**64)  # any whole number, negative too
    n_frames = int(traffic["frames"])
    dt = 1.0 / rig.fps
    ts = np.arange(n_frames) * dt
    pos_fn, rotvec_fn = motion_fns(traffic["motion"])
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    poses[:, :3, :3] = _np_expmap(rotvec_fn(ts).reshape(-1, 3))
    poses[:, :3, 3] = pos_fn(ts)
    layout = traffic["landmarks"]
    pts = _landmarks(rng, layout, float(poses[:, 2, 3].max()))
    # make_scene's textures: "classic" smooth noise on a dark background,
    # "distinct" coarse iid blobs on mid-gray (descriptors near-iid across
    # patches, which wide-radius matching needs)
    distinct = layout.get("texture", "classic") == "distinct"
    patch_fn = _make_patch_coarse if distinct else _make_patch
    patches = np.stack([patch_fn(rng) for _ in range(len(pts))])
    imu = _imu_from_analytic(n_frames, dt, rig.imu_hz, pos_fn, rotvec_fn)
    if rig.imu_noise is not None:
        imu = _add_imu_noise(rng, imu, rig.imu_hz, *rig.imu_noise)
    fx, fy, cx, cy = rig.K
    eps = 1e-4
    return SyntheticScene(
        width=rig.width,
        height=rig.height,
        K=np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]]),
        baseline=rig.baseline,
        points_w=pts,
        patches=patches,
        times=ts,
        poses_c2w=poses,
        velocities=(pos_fn(ts + eps) - pos_fn(ts - eps)) / (2 * eps),
        imu=imu,
        imu_hz=rig.imu_hz,
        background=120.0 if distinct else 15.0,
    )
