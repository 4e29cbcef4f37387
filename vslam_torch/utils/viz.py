"""Map / trajectory export (the port of vslam_tpu/utils/viz.py).

A headless replacement for the reference's Iridescence live viewer
(reference src/Visualization.cpp:125-143: point cloud colored by activity
59-94, camera frusta 7-57, per-KF frusta 96-118):

- :func:`export_ply`: landmarks (+ trajectory) as an ASCII PLY point cloud
  for any external viewer (MeshLab, CloudCompare);
- :func:`export_html`: a self-contained interactive HTML viewer (canvas 3D:
  orbit, zoom, colored landmarks, KF frusta, the trajectory) with the
  scene embedded as JSON;
- :class:`LiveMapWriter`: the viewer rewritten every N new keyframes.

Each export reads the map tensors to the host once (``.cpu()``); nothing
here runs per frame. The files are byte-for-byte those of the JAX
package for the same map.
"""

from __future__ import annotations

import json
import os

import numpy as np

from vslam_torch.models import map_state


def _collect(
    world: map_state.WorldMap,
    trajectory: np.ndarray | None,
    active_ids: np.ndarray | None = None,
):
    """Landmark positions + per-landmark activity, KF poses and the
    trajectory's positions, on the host. `active_ids` = the tracker's live
    active-set slots; those landmarks are colored "active", as the
    reference's viewer tells activeMapPoints from the rest
    (src/Visualization.cpp:59-94)."""
    m = world.arrays
    valid = m.lm_valid.cpu().numpy()
    pts = m.lm_pos.cpu().numpy()[valid]
    act = np.zeros(len(valid), bool)
    if active_ids is not None:
        ids = np.asarray(active_ids)
        ids = ids[(ids >= 0) & (ids < len(valid))]
        act[ids] = True
    act = act[valid]
    kf_poses = world.kf_poses_host[: world.n_keyframes]
    traj = (
        np.asarray(trajectory)[:, :3, 3]
        if trajectory is not None and len(trajectory)
        else np.zeros((0, 3))
    )
    return pts, act, kf_poses, traj


def export_ply(
    path: str,
    world: map_state.WorldMap,
    trajectory: np.ndarray | None = None,
    active_ids: np.ndarray | None = None,
):
    """Landmarks (active green / inactive gray, the reference's activity
    coloring, src/Visualization.cpp:59-94) + trajectory (red) as ASCII
    PLY."""
    pts, act, _, traj = _collect(world, trajectory, active_ids)
    n = len(pts) + len(traj)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, a in zip(pts, act):
            col = "70 210 120" if a else "200 200 200"
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {col}\n")
        for p in traj:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 230 40 40\n")


# the page is the JAX package's, title included, so that both packages
# write the same file for the same map
_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>vslam_tpu map</title>
<style>body{margin:0;background:#101014;color:#ddd;font:12px monospace}
#hud{position:fixed;top:8px;left:8px}</style></head>
<body><canvas id="c"></canvas><div id="hud"></div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw=-0.6, pitch=-0.35, dist=0.0, cx=0, cy=0, cz=0, zoom=40;
try{const v=JSON.parse(localStorage.getItem('vslam_view')||'null');
  if(v){yaw=v.yaw;pitch=v.pitch;zoom=v.zoom;}}catch(e){}
function saveView(){try{localStorage.setItem('vslam_view',
  JSON.stringify({yaw,pitch,zoom}));}catch(e){}}
(function(){ // center on the data
  const all = DATA.points.concat(DATA.traj);
  if(all.length){
    let s=[0,0,0]; for(const p of all){s[0]+=p[0];s[1]+=p[1];s[2]+=p[2];}
    cx=s[0]/all.length; cy=s[1]/all.length; cz=s[2]/all.length;
  }
})();
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw();}
addEventListener('resize',resize);
let drag=false,lx=0,ly=0;
cv.addEventListener('mousedown',e=>{drag=true;lx=e.clientX;ly=e.clientY});
addEventListener('mouseup',()=>drag=false);
addEventListener('mousemove',e=>{if(!drag)return;yaw+=(e.clientX-lx)*0.005;
  pitch+=(e.clientY-ly)*0.005;lx=e.clientX;ly=e.clientY;saveView();draw();});
cv.addEventListener('wheel',e=>{zoom*=Math.exp(-e.deltaY*0.001);saveView();draw();e.preventDefault();});
function proj(p){
  let x=p[0]-cx, y=p[1]-cy, z=p[2]-cz;
  let x1=x*Math.cos(yaw)+z*Math.sin(yaw), z1=-x*Math.sin(yaw)+z*Math.cos(yaw);
  let y2=y*Math.cos(pitch)-z1*Math.sin(pitch), z2=y*Math.sin(pitch)+z1*Math.cos(pitch);
  const s=zoom*300/(300+z2*zoom*0.02+dist);
  return [cv.width/2+x1*s, cv.height/2+y2*s, z2];
}
function line(a,b,col,w){const pa=proj(a),pb=proj(b);ctx.strokeStyle=col;
  ctx.lineWidth=w||1;ctx.beginPath();ctx.moveTo(pa[0],pa[1]);ctx.lineTo(pb[0],pb[1]);ctx.stroke();}
function draw(){
  ctx.fillStyle='#101014';ctx.fillRect(0,0,cv.width,cv.height);
  for(let i=0;i<DATA.points.length;i++){const q=proj(DATA.points[i]);
    ctx.fillStyle=DATA.active[i]?'#49d17a':'#8a8a94';
    ctx.fillRect(q[0]-1,q[1]-1,2,2);}
  for(let i=1;i<DATA.traj.length;i++) line(DATA.traj[i-1],DATA.traj[i],'#e62828',2);
  for(const f of DATA.frusta){ // 5 points: apex + 4 image-plane corners
    for(let i=1;i<=4;i++){line(f[0],f[i],'#3ba7ff',1);
      line(f[i],f[i%4+1],'#3ba7ff',1);}
  }
  document.getElementById('hud').textContent =
    DATA.points.length+' landmarks ('+DATA.active.filter(Boolean).length+' active) | '+DATA.frusta.length+' keyframes | drag to orbit, wheel to zoom';
}
resize();
// LIVE mode (reference Visualization.cpp:125-143 renders continuously):
// poll the sibling .json for fresh map data — works when the directory
// is served (python -m http.server); under file:// fetch is blocked, so
// fall back to a full reload (the orbit state survives in localStorage).
if (DATA.live_ms) {
  const url = location.href.replace(/[.]html([?].*)?$/, '.json');
  let failed = false;
  setInterval(async () => {
    if (failed) return;
    try {
      const r = await fetch(url + '?t=' + Date.now(), {cache: 'no-store'});
      if (!r.ok) throw new Error(r.status);
      const d = await r.json();
      DATA.points = d.points; DATA.active = d.active;
      DATA.traj = d.traj; DATA.frusta = d.frusta;
      draw();
    } catch (e) {
      failed = true;  // file:// — reload instead (view state persisted)
      setTimeout(() => location.reload(), DATA.live_ms);
    }
  }, DATA.live_ms);
}
</script></body></html>
"""


def export_html(
    path: str,
    world: map_state.WorldMap,
    trajectory: np.ndarray | None = None,
    frustum_scale: float = 0.4,
    max_points: int = 20000,
    active_ids: np.ndarray | None = None,
    live_reload_ms: int | None = None,
):
    """Self-contained interactive HTML viewer of the current map; returns
    the embedded data.

    `live_reload_ms`: the page polls a sibling `<path minus .html>.json`
    (written by :class:`LiveMapWriter`) at this interval and redraws in
    place; under file:// (fetch blocked) it reloads instead, the orbit
    state carried through localStorage."""
    pts, act, kf_poses, traj = _collect(world, trajectory, active_ids)
    if len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[sel]
        act = act[sel]
    frusta = []
    s = frustum_scale
    corners = np.array(
        [[-s, -s * 0.6, s * 1.2], [s, -s * 0.6, s * 1.2], [s, s * 0.6, s * 1.2], [-s, s * 0.6, s * 1.2]]
    )
    for T in kf_poses:
        apex = T[:3, 3]
        cs = (T[:3, :3] @ corners.T).T + apex
        frusta.append([apex.tolist()] + cs.tolist())
    data = {
        "points": np.round(pts, 3).tolist(),
        "active": [int(a) for a in act],
        "traj": np.round(traj, 3).tolist(),
        "frusta": frusta,
        "live_ms": int(live_reload_ms) if live_reload_ms else 0,
    }
    with open(path, "w") as f:
        f.write(_HTML_TEMPLATE.replace("__DATA__", json.dumps(data)))
    return data


class LiveMapWriter:
    """Incremental map export: rewrite the HTML viewer + a sibling .json
    every `every_n_kf` inserted keyframes (atomic tmp + rename, so a reader
    never sees a torn file). The page refreshes itself (see
    :func:`export_html`), the headless stand-in for the reference's live
    render loop (src/Visualization.cpp:125-143)."""

    def __init__(
        self, path: str, world: map_state.WorldMap, every_n_kf: int = 5,
        reload_ms: int = 2000,
    ):
        self.path = path
        self.world = world
        self.every = max(int(every_n_kf), 1)
        self.reload_ms = int(reload_ms)
        self._last_n = 0

    def maybe_export(self, tracker=None) -> bool:
        """Export when `every` keyframes were added since the last export;
        returns whether it did."""
        n = self.world.n_keyframes
        if n - self._last_n < self.every:
            return False
        self._last_n = n
        traj = None
        active = None
        if tracker is not None:
            # recomposed from the host mirrors: no device read
            traj = np.stack(
                [self.world.kf_poses_host[s] @ rel for s, rel in tracker.frame_records]
            ) if tracker.frame_records else None
            active = tracker.active_ids
        tmp = self.path + ".tmp"
        data = export_html(tmp, self.world, traj, active_ids=active, live_reload_ms=self.reload_ms)
        os.replace(tmp, self.path)
        base = self.path[:-5] if self.path.endswith(".html") else self.path
        jtmp = base + ".json.tmp"
        with open(jtmp, "w") as f:
            json.dump(data, f)
        os.replace(jtmp, base + ".json")
        return True
