"""Interactive 3-D point-cloud viewer as a standalone HTML file.

A copy of `complex_yolov4_tpu/utils/viewer_html.py` (numpy only; reference:
src/utils/visualization_utils.py:14-134, `show_lidar` / `draw_lidar` /
`draw_gt_boxes3d`): a self-contained WebGL page with orbit / pan / zoom,
height- or intensity-colored points and class-colored wireframe boxes, no
external JS dependencies (works offline from file://). The point cloud is
embedded as a base64 Float32Array; a full KITTI frame (~120k points) is
~2 MB of HTML. `tests/test_torch_port_copies.py` holds the copy equal to
the original.
"""

from __future__ import annotations

import base64
import json
from typing import Optional

import numpy as np

from ..data.targets import inverse_yolo_targets

# BGR tuples in config.kitti COLORS; the viewer wants normalized RGB.
_CLASS_RGB = {0: (0.0, 1.0, 1.0), 1: (0.0, 0.37, 1.0), 2: (1.0, 0.0, 1.0)}
_DEFAULT_RGB = (1.0, 0.3, 0.3)


def detections_to_lidar_boxes(detections: np.ndarray, det_mask: np.ndarray,
                              img_size: float) -> np.ndarray:
    """NMS rows (K, 9) + mask -> (N, 8) lidar [cls, x, y, z, h, w, l, rz]
    for 3-D display (same decode as visualization.detections_to_kitti_objects
    but staying in the lidar frame; z is the fixed class-height anchor the
    reference uses, kitti_bev_utils.py:141-159)."""
    live = np.asarray(detections)[np.asarray(det_mask) > 0.5]
    if live.shape[0] == 0:
        return np.zeros((0, 8), np.float64)
    rows = np.zeros((live.shape[0], 7), np.float64)
    rows[:, 0] = live[:, 8]
    rows[:, 1:5] = live[:, :4] / img_size
    rows[:, 5:7] = live[:, 4:6]
    labels = inverse_yolo_targets(rows)  # [cls, x, y, z, h, w, l, ry_cam]
    # viewer yaw about lidar z: the BEV yaw atan2(im, re) == -(ry + 2pi)
    labels[:, 7] = -labels[:, 7] - 2.0 * np.pi
    return labels


def _box_wireframe(x, y, z, h, w, l, yaw):
    """12-edge wireframe (24 xyz vertices) of one lidar-frame box; z is the
    vertical center (save_lidar_3d convention)."""
    c, s = np.cos(yaw), np.sin(yaw)
    dx = np.array([l, l, -l, -l]) / 2.0
    dy = np.array([w, -w, -w, w]) / 2.0
    cx = x + dx * c - dy * s
    cy = y + dx * s + dy * c
    lo, hi = z - h / 2.0, z + h / 2.0
    verts = []
    for k in range(4):
        k2 = (k + 1) % 4
        verts += [[cx[k], cy[k], lo], [cx[k2], cy[k2], lo]]
        verts += [[cx[k], cy[k], hi], [cx[k2], cy[k2], hi]]
        verts += [[cx[k], cy[k], lo], [cx[k], cy[k], hi]]
    return verts


def save_lidar_html(points: np.ndarray, path: str,
                    boxes_lidar: Optional[np.ndarray] = None,
                    box_classes: Optional[np.ndarray] = None,
                    title: str = "complex_yolov4_tpu lidar viewer",
                    max_points: int = 400_000) -> None:
    """Write an interactive WebGL viewer for `points` (N, 3|4) with optional
    (M, 7) lidar boxes [x, y, z, h, w, l, yaw] colored by `box_classes`."""
    pts = np.asarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"points must be (N, 3|4), got {pts.shape}")
    if pts.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(pts.shape[0], max_points,
                                              replace=False)
        pts = pts[sel]
    xyzi = np.zeros((pts.shape[0], 4), np.float32)
    xyzi[:, :3] = pts[:, :3]
    if pts.shape[1] >= 4:
        xyzi[:, 3] = pts[:, 3]
    pts_b64 = base64.b64encode(np.ascontiguousarray(xyzi).tobytes()).decode()

    line_verts, line_cols = [], []
    if boxes_lidar is not None:
        boxes = np.asarray(boxes_lidar, np.float64).reshape(-1, 7)
        classes = (np.asarray(box_classes).reshape(-1)
                   if box_classes is not None else np.zeros(boxes.shape[0]) - 1)
        for i, b in enumerate(boxes):
            verts = _box_wireframe(*b)
            rgb = _CLASS_RGB.get(int(classes[i]), _DEFAULT_RGB) \
                if classes[i] >= 0 else _DEFAULT_RGB
            line_verts += verts
            line_cols += [list(rgb)] * len(verts)
    lines_json = json.dumps(
        {"verts": np.asarray(line_verts, np.float32).round(3).tolist(),
         "cols": np.asarray(line_cols, np.float32).round(3).tolist()})

    zvals = xyzi[:, 2]
    z_lo = float(np.percentile(zvals, 2)) if len(zvals) else -2.0
    z_hi = float(np.percentile(zvals, 98)) if len(zvals) else 1.0
    if z_hi - z_lo < 1e-3:
        z_hi = z_lo + 1.0
    center = xyzi[:, :3].mean(axis=0).tolist() if len(zvals) else [0, 0, 0]

    html = _TEMPLATE
    for key, val in [
        ("__TITLE__", title),
        ("__NPTS__", str(xyzi.shape[0])),
        ("__NBOXES__", str(0 if boxes_lidar is None
                           else int(np.asarray(boxes_lidar).reshape(-1, 7).shape[0]))),
        ("__PTS_B64__", pts_b64),
        ("__LINES__", lines_json),
        ("__ZLO__", f"{z_lo:.3f}"),
        ("__ZHI__", f"{z_hi:.3f}"),
        ("__CENTER__", json.dumps([round(c, 3) for c in center])),
    ]:
        html = html.replace(key, val)
    with open(path, "w") as f:
        f.write(html)


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
  html,body{margin:0;height:100%;background:#0b0e14;overflow:hidden;
    font:12px/1.4 system-ui,sans-serif;color:#c8cdd8}
  #c{width:100%;height:100%;display:block;cursor:grab}
  #hud{position:fixed;left:10px;top:10px;background:rgba(11,14,20,.75);
    padding:8px 12px;border-radius:6px;pointer-events:none;white-space:pre}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">__TITLE__
__NPTS__ points, __NBOXES__ boxes
drag: orbit | shift-drag / right-drag: pan | wheel: zoom
c: color height/intensity | +/-: point size | r: reset</div>
<script>
"use strict";
const b64 = "__PTS_B64__";
const raw = atob(b64), n = raw.length / 16 | 0;
const buf = new ArrayBuffer(raw.length);
const u8 = new Uint8Array(buf);
for (let i = 0; i < raw.length; i++) u8[i] = raw.charCodeAt(i);
const pts = new Float32Array(buf);          // x y z i interleaved
const lines = __LINES__;
const zlo = __ZLO__, zhi = __ZHI__, center = __CENTER__;

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias: true});
if (!gl) document.getElementById("hud").textContent = "WebGL unavailable";

function sh(type, src) {
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}
function prog(vs, fs) {
  const p = gl.createProgram();
  gl.attachShader(p, sh(gl.VERTEX_SHADER, vs));
  gl.attachShader(p, sh(gl.FRAGMENT_SHADER, fs));
  gl.linkProgram(p); return p;
}
const ptProg = prog(`
  attribute vec4 a;            // xyz + intensity
  uniform mat4 mvp; uniform float psize; uniform float mode;
  uniform vec2 zr;
  varying vec3 vc;
  vec3 ramp(float t){          // viridis-ish 5-stop ramp
    t = clamp(t, 0.0, 1.0);
    vec3 c0 = vec3(0.267,0.005,0.329), c1 = vec3(0.229,0.322,0.546),
         c2 = vec3(0.128,0.567,0.551), c3 = vec3(0.369,0.789,0.383),
         c4 = vec3(0.993,0.906,0.144);
    if (t < 0.25) return mix(c0, c1, t / 0.25);
    if (t < 0.5)  return mix(c1, c2, (t - 0.25) / 0.25);
    if (t < 0.75) return mix(c2, c3, (t - 0.5) / 0.25);
    return mix(c3, c4, (t - 0.75) / 0.25);
  }
  void main(){
    gl_Position = mvp * vec4(a.xyz, 1.0);
    gl_PointSize = psize;
    float t = mode < 0.5 ? (a.z - zr.x) / (zr.y - zr.x) : a.w;
    vc = ramp(t);
  }`, `
  precision mediump float; varying vec3 vc;
  void main(){ gl_FragColor = vec4(vc, 1.0); }`);
const lnProg = prog(`
  attribute vec3 a; attribute vec3 col; uniform mat4 mvp; varying vec3 vc;
  void main(){ gl_Position = mvp * vec4(a, 1.0); vc = col; }`, `
  precision mediump float; varying vec3 vc;
  void main(){ gl_FragColor = vec4(vc, 1.0); }`);

const ptBuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, ptBuf);
gl.bufferData(gl.ARRAY_BUFFER, pts, gl.STATIC_DRAW);
let nLine = 0, lnBuf = null, lcBuf = null;
if (lines.verts.length) {
  nLine = lines.verts.length;
  const lv = new Float32Array(nLine * 3), lc = new Float32Array(nLine * 3);
  lines.verts.forEach((v, i) => lv.set(v, i * 3));
  lines.cols.forEach((v, i) => lc.set(v, i * 3));
  lnBuf = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, lnBuf);
  gl.bufferData(gl.ARRAY_BUFFER, lv, gl.STATIC_DRAW);
  lcBuf = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, lcBuf);
  gl.bufferData(gl.ARRAY_BUFFER, lc, gl.STATIC_DRAW);
}

// --- tiny mat4 helpers (column-major) ---
function persp(fovy, asp, near, far) {
  const f = 1 / Math.tan(fovy / 2), nf = 1 / (near - far);
  return [f/asp,0,0,0, 0,f,0,0, 0,0,(far+near)*nf,-1, 0,0,2*far*near*nf,0];
}
function mul(a, b) {
  const o = new Array(16).fill(0);
  for (let c = 0; c < 4; c++) for (let r = 0; r < 4; r++)
    for (let k = 0; k < 4; k++) o[c*4+r] += a[k*4+r] * b[c*4+k];
  return o;
}
function lookFrom(yaw, pitch, dist, tgt) {
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const eye = [tgt[0] - dist*cp*Math.cos(yaw),
               tgt[1] - dist*cp*Math.sin(yaw),
               tgt[2] + dist*sp];
  let f = [tgt[0]-eye[0], tgt[1]-eye[1], tgt[2]-eye[2]];
  const fl = Math.hypot(...f); f = f.map(v => v/fl);
  const upw = [0,0,1];
  let s = [f[1]*upw[2]-f[2]*upw[1], f[2]*upw[0]-f[0]*upw[2],
           f[0]*upw[1]-f[1]*upw[0]];
  const sl = Math.hypot(...s) || 1; s = s.map(v => v/sl);
  const u = [s[1]*f[2]-s[2]*f[1], s[2]*f[0]-s[0]*f[2], s[0]*f[1]-s[1]*f[0]];
  return {m: [s[0],u[0],-f[0],0, s[1],u[1],-f[1],0, s[2],u[2],-f[2],0,
              -(s[0]*eye[0]+s[1]*eye[1]+s[2]*eye[2]),
              -(u[0]*eye[0]+u[1]*eye[1]+u[2]*eye[2]),
              f[0]*eye[0]+f[1]*eye[1]+f[2]*eye[2], 1], s: s, u: u};
}

const home = {yaw: Math.PI, pitch: 0.6, dist: 60};
let yaw = home.yaw, pitch = home.pitch, dist = home.dist;
let tgt = center.slice(), mode = 0, psize = 1.5;
let drag = null;
canvas.addEventListener("mousedown", e => {
  drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey || e.button === 2};
});
window.addEventListener("mouseup", () => drag = null);
window.addEventListener("mousemove", e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) {
    const v = lookFrom(yaw, pitch, dist, tgt), k = dist * 0.0015;
    tgt[0] -= (v.s[0]*dx - v.u[0]*dy) * k;
    tgt[1] -= (v.s[1]*dx - v.u[1]*dy) * k;
    tgt[2] -= (v.s[2]*dx - v.u[2]*dy) * k;
  } else {
    yaw -= dx * 0.005;
    pitch = Math.min(1.55, Math.max(-1.55, pitch + dy * 0.005));
  }
  draw();
});
canvas.addEventListener("contextmenu", e => e.preventDefault());
canvas.addEventListener("wheel", e => {
  e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001);
  dist = Math.min(500, Math.max(2, dist)); draw();
}, {passive: false});
window.addEventListener("keydown", e => {
  if (e.key === "c") mode = 1 - mode;
  else if (e.key === "+" || e.key === "=") psize = Math.min(8, psize + 0.5);
  else if (e.key === "-") psize = Math.max(0.5, psize - 0.5);
  else if (e.key === "r") {
    yaw = home.yaw; pitch = home.pitch; dist = home.dist;
    tgt = center.slice();
  } else return;
  draw();
});

function draw() {
  const w = canvas.clientWidth, h = canvas.clientHeight;
  if (canvas.width !== w || canvas.height !== h) {
    canvas.width = w; canvas.height = h;
  }
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.043, 0.055, 0.078, 1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const mvp = mul(persp(0.9, w / h, 0.5, 2000),
                  lookFrom(yaw, pitch, dist, tgt).m);
  gl.useProgram(ptProg);
  gl.uniformMatrix4fv(gl.getUniformLocation(ptProg, "mvp"), false, mvp);
  gl.uniform1f(gl.getUniformLocation(ptProg, "psize"), psize);
  gl.uniform1f(gl.getUniformLocation(ptProg, "mode"), mode);
  gl.uniform2f(gl.getUniformLocation(ptProg, "zr"), zlo, zhi);
  gl.bindBuffer(gl.ARRAY_BUFFER, ptBuf);
  const la = gl.getAttribLocation(ptProg, "a");
  gl.enableVertexAttribArray(la);
  gl.vertexAttribPointer(la, 4, gl.FLOAT, false, 16, 0);
  gl.drawArrays(gl.POINTS, 0, n);
  if (nLine) {
    gl.useProgram(lnProg);
    gl.uniformMatrix4fv(gl.getUniformLocation(lnProg, "mvp"), false, mvp);
    gl.bindBuffer(gl.ARRAY_BUFFER, lnBuf);
    const a = gl.getAttribLocation(lnProg, "a");
    gl.enableVertexAttribArray(a);
    gl.vertexAttribPointer(a, 3, gl.FLOAT, false, 12, 0);
    gl.bindBuffer(gl.ARRAY_BUFFER, lcBuf);
    const c = gl.getAttribLocation(lnProg, "col");
    gl.enableVertexAttribArray(c);
    gl.vertexAttribPointer(c, 3, gl.FLOAT, false, 12, 0);
    gl.drawArrays(gl.LINES, 0, nLine);
  }
}
window.addEventListener("resize", draw);
draw();
</script></body></html>
"""
