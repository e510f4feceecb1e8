"""Headless visualization exports (port of
`moshpp_tpu/tools/visualization.py`).

The reference renders live OpenGL windows (psbody MeshViewer,
`tools/visualization.py`, `marker_layout/edit_tools.py:288-416`); a GPU
fleet has no display, so everything here writes inspection artifacts to disk
instead: PLY meshes with marker spheres, C3D marker clouds, and per-frame
body meshes for shape/pose estimates.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from moshpp_torch.io.mocap import write_mocap_c3d
from moshpp_torch.io.ply import write_ply
from moshpp_torch.io.model_loader import load_surface_model
from moshpp_torch.markers.layout import marker_layout_load
from moshpp_torch.models.body_model import lbs_forward
from moshpp_torch.models.synthetic import icosphere
from moshpp_torch.ops.surface import vertex_normals
from moshpp_torch.utils.rotations import rotate_points_xyz

MARKER_RADIUS = {"body": 0.009, "face": 0.004, "finger": 0.005}


def _sphere_cloud(centers: np.ndarray, radii: np.ndarray,
                  colors: Optional[np.ndarray] = None):
    """Concatenate small icospheres at each center; returns (verts, faces, colors)."""
    sv, sf = icosphere(1)
    verts, faces, cols = [], [], []
    off = 0
    for i, c in enumerate(centers):
        verts.append(sv * radii[i] + c)
        faces.append(sf + off)
        col = colors[i] if colors is not None else np.array([1.0, 0.0, 0.0])
        cols.append(np.tile(col, (len(sv), 1)))
        off += len(sv)
    return (np.concatenate(verts), np.concatenate(faces), np.concatenate(cols))


def marker_layout_as_mesh(surface_model_fname: str,
                          body_parms: Optional[dict] = None,
                          preserve_vertex_order: bool = True,
                          surface_model_type: Optional[str] = None,
                          *, device):
    """Render a marker layout as spheres on the (optionally shaped/posed)
    body; returns a writer closure like the reference (edit_tools.py:288-390).
    The body is posed on `device`."""
    body_parms = body_parms or {}
    model = load_surface_model(surface_model_fname,
                               surface_model_type=surface_model_type,
                               device=device)
    betas = np.zeros(model.num_betas, np.float32)
    if body_parms.get("betas") is not None:
        b = np.asarray(body_parms["betas"], np.float32).ravel()
        betas[: len(b)] = b[: model.num_betas]
    pose = np.zeros(model.pose_dof, np.float32)
    if body_parms.get("pose_body") is not None:
        pb = np.asarray(body_parms["pose_body"], np.float32).ravel()
        pose[3:3 + len(pb)] = pb
    t = lambda a: torch.as_tensor(a, device=model.device)
    verts_t = lbs_forward(model, t(pose[None]), t(betas),
                          torch.zeros((1, 3), device=model.device))[0]
    verts = verts_t.cpu().numpy()
    vn = vertex_normals(verts_t, model.faces).cpu().numpy()
    faces = model.faces.cpu().numpy()

    def as_mesh(marker_layout_fname: Union[str, dict],
                out_fname: Optional[str] = None,
                marker_colors: Optional[Dict] = None) -> dict:
        meta = (marker_layout_fname if isinstance(marker_layout_fname, dict)
                else marker_layout_load(marker_layout_fname))
        labels = list(meta["marker_vids"].keys())
        vids = [v[0] if isinstance(v, list) else v
                for v in meta["marker_vids"].values()]
        m2b = np.full(len(vids), 0.0095)
        radii = np.full(len(vids), MARKER_RADIUS["body"])
        for mtype, mask in meta["marker_type_mask"].items():
            mask = np.asarray(mask, bool)
            m2b[mask] = meta["m2b_distance"][mtype]
            for key, r in MARKER_RADIUS.items():
                if key in mtype:
                    radii[mask] = r
        markers = verts[vids] + vn[vids] * m2b[:, None]
        if marker_colors is not None:
            cols = np.array([marker_colors[l] for l in labels])
        else:
            cols = np.array([meta["marker_colors"][l] for l in labels]) \
                if "marker_colors" in meta else None

        mv, mf, mc = _sphere_cloud(markers, radii, cols)
        all_v = np.concatenate([verts, mv])
        all_f = np.concatenate([faces, mf + len(verts)])
        all_c = np.concatenate([np.tile([0.65, 0.65, 0.65], (len(verts), 1)), mc])
        if out_fname is not None:
            assert str(out_fname).endswith(".ply")
            write_ply(str(out_fname), all_v, all_f, vertex_colors=all_c)
        return {"markers": markers, "labels": labels,
                "body_verts": verts, "body_faces": faces}

    return as_mesh


def marker_layout_to_c3d(marker_layout_fname: str, surface_model_fname: str,
                         surface_model_type: Optional[str] = None,
                         out_c3d_fname: Optional[str] = None, *,
                         device) -> None:
    """Export a layout's marker cloud as a C3D for inspection in mocap tools
    (edit_tools.py:393-416)."""
    if out_c3d_fname is None:
        out_c3d_fname = str(marker_layout_fname).replace(".json", ".c3d")
    out = marker_layout_as_mesh(
        surface_model_fname, surface_model_type=surface_model_type,
        device=device)(marker_layout_fname)
    markers = out["markers"] + np.array([0.0, 1.3, 0.0])
    markers = rotate_points_xyz(markers[None], [90, 0, 0])
    markers = np.repeat(markers, 100, axis=0)
    write_mocap_c3d(markers, out["labels"], str(out_c3d_fname), frame_rate=60)


def export_pose_estimate(model, result, out_dir: str, every: int = 10) -> None:
    """Write every-Nth posed body mesh of a stage-ii result as PLY
    (replaces the live viewer, tools/visualization.py:96-128); the bodies
    are posed on the model's device."""
    os.makedirs(out_dir, exist_ok=True)
    F = result.trans.shape[0]
    ts = list(range(0, F, every))
    # extras (dmpl/expr) are already folded into result.pose solves; for the
    # export the base betas suffice
    idx = torch.as_tensor(ts, device=result.pose.device)
    pose = result.pose[idx].to(model.device)
    trans = result.trans[idx].to(model.device)
    verts = lbs_forward(model, pose, torch.zeros(model.num_betas,
                                                 device=model.device),
                        trans).cpu().numpy()
    faces = model.faces.cpu().numpy()
    for i, t in enumerate(ts):
        write_ply(os.path.join(out_dir, f"frame_{t:05d}.ply"), verts[i], faces)


def play_mocap_trajectories(markers: np.ndarray,
                            out_html: str,
                            labels: Optional[list] = None,
                            frame_rate: float = 120.0,
                            title: str = "mocap trajectories") -> str:
    """Write a self-contained interactive HTML player for marker
    trajectories — the headless equivalent of the reference's OpenGL
    `play_mocap_trajectories` (mocap_interface.py:305). No dependencies:
    embedded data + a small canvas renderer (drag to orbit, space to
    play/pause, scrub bar). Returns the output path.
    """
    m = np.asarray(markers, np.float32)
    assert m.ndim == 3 and m.shape[-1] == 3, "markers must be (F, M, 3)"
    nan_mask = ~np.isfinite(m).all(-1) | (np.abs(m) < 1e-9).all(-1)
    center = np.nanmean(np.where(nan_mask[..., None], np.nan, m),
                        axis=(0, 1))
    center = np.where(np.isfinite(center), center, 0.0)
    data = {
        "frames": np.where(nan_mask[..., None], np.float32(np.nan),
                           m - center).round(4).tolist(),
        "labels": list(labels) if labels is not None else
        [f"m{i}" for i in range(m.shape[1])],
        "fps": float(frame_rate),
        "title": title,
    }
    import json as _json
    html = """<!doctype html><meta charset="utf-8"><title>%TITLE%</title>
<style>body{margin:0;background:#111;color:#ccc;font:13px monospace}
canvas{display:block}#hud{position:fixed;top:8px;left:8px}
#bar{position:fixed;bottom:8px;left:8px;right:8px}</style>
<canvas id=c></canvas><div id=hud></div>
<input id=bar type=range min=0 value=0 step=1>
<script>
const D=%DATA%;const F=D.frames.length,M=D.frames[0].length;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
const bar=document.getElementById('bar');bar.max=F-1;
let t=0,playing=true,ry=0.6,rx=0.3,zoom=280,last=0;
function resize(){cv.width=innerWidth;cv.height=innerHeight-30}
addEventListener('resize',resize);resize();
function draw(){
 ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
 const cy=Math.cos(ry),sy=Math.sin(ry),cx=Math.cos(rx),sx=Math.sin(rx);
 const fr=D.frames[t];ctx.fillStyle='#e44';
 for(let i=0;i<M;i++){const p=fr[i];if(!isFinite(p[0]))continue;
  const X=p[0]*cy+p[2]*sy, Z=-p[0]*sy+p[2]*cy;
  const Y=p[1]*cx-Z*sx;
  ctx.beginPath();
  ctx.arc(cv.width/2+X*zoom,cv.height/2-Y*zoom,3,0,7);ctx.fill();}
 document.getElementById('hud').textContent=
  D.title+'  frame '+t+'/'+(F-1)+'  ('+D.fps+' fps, space=pause, drag=orbit, wheel=zoom)';
 bar.value=t;}
function tick(ts){if(playing&&ts-last>1000/D.fps){t=(t+1)%F;last=ts}
 draw();requestAnimationFrame(tick)}
requestAnimationFrame(tick);
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
onmouseup=()=>drag=null;
onmousemove=e=>{if(drag){ry+=(e.clientX-drag[0])*0.01;
 rx+=(e.clientY-drag[1])*0.01;drag=[e.clientX,e.clientY]}};
onwheel=e=>zoom*=e.deltaY<0?1.1:0.9;
onkeydown=e=>{if(e.code==='Space'){playing=!playing;e.preventDefault()}};
bar.oninput=()=>{t=+bar.value;playing=false};
</script>"""
    html = html.replace("%TITLE%", title).replace("%DATA%", _json.dumps(data))
    os.makedirs(os.path.dirname(os.path.abspath(out_html)), exist_ok=True)
    with open(out_html, "w") as f:
        f.write(html)
    return out_html


def phase_snapshot_writer(out_dir: str, every: int = 1):
    """An `on_phase` callback for `mosh_stageii_solve`: dumps the simulated
    markers after each solve phase as npz snapshots — the headless stand-in
    for the reference's live `visualize_pose_estimate` windows
    (tools/visualization.py:96-128, enabled at verbosity > 1).
    """
    os.makedirs(out_dir, exist_ok=True)
    state = {"n": 0}

    def on_phase(phase_name: str, x, markers_sim) -> None:
        state["n"] += 1
        if (state["n"] - 1) % every:
            return
        np.savez(os.path.join(out_dir,
                              f"{state['n']:02d}_{phase_name}.npz"),
                 x=np.asarray(x), markers_sim=np.asarray(markers_sim))

    return on_phase
