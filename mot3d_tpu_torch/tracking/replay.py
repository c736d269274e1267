"""Interactive 4D sequence replay as a single self-contained HTML file
(counterpart of `mot3d_tpu/tracking/replay.py`).

The reference replays GT/predicted sequences in dvis, a web viewer
(`Tracking/visualise/visualise.py:13-726`: per-frame meshes, tracklet
lines, background point cloud).  dvis needs a running server; this module
emits one portable HTML file with the sequence data embedded as JSON and a
tiny dependency-free canvas renderer: orbit (drag), zoom (wheel), a time
slider + play button, per-trajectory colors, wireframe 3D boxes, tracklet
polylines and an optional background point cloud.

Usage:
    write_replay_html("replay.html", trajectories, gt_trajectories=...,
                      background_pc=pts, seq_len=25)
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

_PALETTE = ["#e41a1c", "#377eb8", "#4daf4a", "#984ea3", "#ff7f00",
            "#a65628", "#f781bf", "#17becf", "#bcbd22", "#8c564b"]


def _traj_records(trajectories: List[List[dict]], with_pose: bool = False):
    out = []
    for i, traj in enumerate(trajectories):
        recs = []
        for d in traj:
            rec = {"t": int(d["scan_idx"]),
                   "loc": np.asarray(d["loc"], np.float64).round(4).tolist()}
            if "box" in d and d["box"] is not None:
                box = np.asarray(d["box"], np.float64)
                if box.shape == (8, 3):
                    rec["box"] = box.round(4).tolist()
            if "cls" in d:
                rec["cls"] = int(d["cls"])
            if with_pose and "euler" in d:
                # Embed the rotation MATRIX (not euler) so the JS renderer
                # cannot drift from geometry.transforms' convention.
                from mot3d_tpu_torch.tracking.visualise import _rotmat
                rec["R"] = np.asarray(_rotmat(d["euler"]),
                                      np.float64).round(4).tolist()
            recs.append(rec)
        out.append({"id": i, "color": _PALETTE[i % len(_PALETTE)],
                    "dets": recs})
    return out


def _fused_points(grid, max_points: int = 150):
    """Canonical-space point set of a fused occupancy grid (voxel centres
    in [-0.5, 0.5]^3, subsampled) for the replay's fused-shape toggle."""
    occ = np.stack(np.nonzero(np.asarray(grid)), 1).astype(np.float64)
    if len(occ) == 0:
        return []
    res = np.asarray(grid).shape[0]
    pts = (occ + 0.5) / res - 0.5
    if len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[sel]
    return pts.round(4).tolist()


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mot3d_tpu replay</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif}
 #hud{position:fixed;top:8px;left:8px;user-select:none}
 #c{display:block}
 input[type=range]{width:360px;vertical-align:middle}
 button{margin-right:6px}
 .gt{opacity:.45}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">
 <button id="play">&#9654;</button>
 <input id="tt" type="range" min="0" max="0" value="0" step="1">
 <span id="lbl"></span>
 <label id="fuselbl" style="display:none"><input id="fuse" type="checkbox"
  checked> fused shapes</label>
 <span style="margin-left:12px;opacity:.6">drag: orbit &middot; wheel: zoom
 &middot; solid: pred &middot; faded: GT</span>
</div>
<script>
const DATA = %DATA%;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W,H; function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
rs(); addEventListener('resize',()=>{rs();draw();});
let yaw=-0.7, pitch=-0.5, dist=8, cx=DATA.center;
let t=0, playing=false;
const slider=document.getElementById('tt'), lbl=document.getElementById('lbl');
slider.max = DATA.seq_len-1;
slider.oninput=()=>{t=+slider.value;draw();};
document.getElementById('play').onclick=()=>{playing=!playing;};
setInterval(()=>{if(playing){t=(t+1)%DATA.seq_len;slider.value=t;draw();}},250);
let drag=false,px=0,py=0;
cv.onmousedown=e=>{drag=true;px=e.clientX;py=e.clientY;};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-px)*.008;
 pitch+=(e.clientY-py)*.008;px=e.clientX;py=e.clientY;draw();};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*.001);draw();e.preventDefault();};
function proj(p){
 const x=p[0]-cx[0],y=p[1]-cx[1],z=p[2]-cx[2];
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const x1=cy*x+sy*y, y1=-sy*x+cy*y;
 const y2=cp*y1+sp*z, z2=-sp*y1+cp*z;
 const zc=dist-y2; if(zc<0.1)return null;
 const f=0.9*Math.min(W,H)/zc;
 return [W/2+f*x1, H/2-f*z2, zc];
}
function line(a,b,col,w,alpha){
 const A=proj(a),B=proj(b); if(!A||!B)return;
 ctx.strokeStyle=col;ctx.lineWidth=w;ctx.globalAlpha=alpha;
 ctx.beginPath();ctx.moveTo(A[0],A[1]);ctx.lineTo(B[0],B[1]);ctx.stroke();
 ctx.globalAlpha=1;
}
function dot(p,col,r,alpha){
 const A=proj(p);if(!A)return;ctx.fillStyle=col;ctx.globalAlpha=alpha;
 ctx.beginPath();ctx.arc(A[0],A[1],r,0,6.3);ctx.fill();ctx.globalAlpha=1;
}
const BOX_E=[[0,1],[1,2],[2,3],[3,0],[4,5],[5,6],[6,7],[7,4],
             [0,4],[1,5],[2,6],[3,7]];
const fuseBox=document.getElementById('fuse');
if(DATA.pred.some(tr=>tr.shape&&tr.shape.length)){
 document.getElementById('fuselbl').style.display='inline';
 fuseBox.onchange=draw;
}
function drawTraj(tr, faded){
 let prev=null;
 for(const d of tr.dets){
  if(d.t>t)break;
  if(prev)line(prev.loc,d.loc,tr.color,1.5,faded?0.35:0.9);
  prev=d;
 }
 for(const d of tr.dets){
  if(d.t!==t)continue;
  dot(d.loc,tr.color,4,faded?0.4:1);
  if(d.box)for(const e of BOX_E)
    line(d.box[e[0]],d.box[e[1]],tr.color,1,faded?0.3:0.8);
  if(!faded&&fuseBox.checked&&tr.shape&&tr.shape.length&&d.R){
   const s=tr.scale||1, R=d.R, L=d.loc;
   for(const p of tr.shape){
    const q=[s*p[0],s*p[1],s*p[2]];
    dot([R[0][0]*q[0]+R[0][1]*q[1]+R[0][2]*q[2]+L[0],
         R[1][0]*q[0]+R[1][1]*q[1]+R[1][2]*q[2]+L[1],
         R[2][0]*q[0]+R[2][1]*q[1]+R[2][2]*q[2]+L[2]],tr.color,1.4,0.7);
   }
  }
 }
}
function draw(){
 ctx.clearRect(0,0,W,H);
 if(DATA.bg)for(const p of DATA.bg)dot(p,'#556',1,0.5);
 for(const tr of DATA.gt||[])drawTraj(tr,true);
 for(const tr of DATA.pred)drawTraj(tr,false);
 lbl.textContent='frame '+t+' / '+(DATA.seq_len-1);
}
draw();
</script></body></html>
"""


def write_replay_html(path: str, trajectories: List[List[dict]],
                      gt_trajectories: Optional[List[List[dict]]] = None,
                      background_pc: Optional[np.ndarray] = None,
                      seq_len: Optional[int] = None,
                      max_bg_points: int = 4000,
                      fused_shapes=None, fused_scales=None) -> str:
    """Write the replay; returns the path.

    `fused_shapes`/`fused_scales` (from visualise.fuse_obj_shape) add a
    "fused shapes" toggle: each tracklet replays ONE canonical shape point
    set, posed per frame with its rotation/translation and the fused scale
    — the reference's fused-mesh replay
    (`Tracking/visualise/visualise.py:619-699`)."""
    with_pose = fused_shapes is not None
    pred = _traj_records(trajectories, with_pose=with_pose)
    if with_pose:
        for i, tr in enumerate(pred):
            grid = fused_shapes[i] if i < len(fused_shapes) else None
            tr["shape"] = _fused_points(grid) if grid is not None else []
            tr["scale"] = (round(float(fused_scales[i]), 4)
                           if fused_scales is not None else 1.0)
    gt = _traj_records(gt_trajectories) if gt_trajectories else []
    all_t = [d["t"] for tr in pred + gt for d in tr["dets"]]
    n = seq_len if seq_len is not None else (max(all_t) + 1 if all_t else 1)
    locs = np.asarray([d["loc"] for tr in pred + gt for d in tr["dets"]]
                      or [[0.0, 0.0, 0.0]])
    bg = None
    if background_pc is not None and len(background_pc):
        pts = np.asarray(background_pc, np.float64)[:, :3]
        if len(pts) > max_bg_points:
            sel = np.linspace(0, len(pts) - 1, max_bg_points).astype(int)
            pts = pts[sel]
        bg = pts.round(3).tolist()
    data = {"pred": pred, "gt": gt, "seq_len": int(n),
            "center": locs.mean(0).round(4).tolist(), "bg": bg}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(_HTML.replace("%DATA%", json.dumps(data)))
    return path
