"""Interactive keypoint and pose adjustment GUI in the browser (port of
`cli/adjust_gui.py`).

The reference's `adjustment: true` mode opens cv2 windows for hand
editing: dragging 2D keypoints (`code/utils/utils.py:61-205`) and
keyboard nudges of shape, global orientation, translation and body pose
(`keyboardCall`, `utils.py:504-572`), then one more solve at the final
stage's weights (`non_linear_solver.py:213-270`).  As in JAX, this is a
page served by the standard library's HTTP server: one overlay canvas
per view with draggable keypoints, the reference's key bindings, and a
Refit button (`fitting/adjust.py:refit_with_observations`).  The first
fit and every refit run on `--device` (CUDA unless ``--device cpu``);
the overlays are drawn, resized and JPEG-encoded on the host without
OpenCV (`viz/overlay.py`, `detect/preprocess.py:resize_linear_u8_by`,
`data/images.py:encode_jpeg`).

    python -m mvsmplfitting_tpu_torch.cli.adjust_gui --config <yaml> \
        [--port 8765] [--frame <serial>/<frame>] [--no_browser] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..data.dataset import frame_to_observations
from ..data.images import encode_jpeg, read_image
from ..data.results import FitOutputs, save_result_pkl
from ..detect.preprocess import resize_linear_u8_by
from ..fitting.adjust import refit_with_observations
from ..fitting.initialize import init_guess
from ..fitting.stages import fit_frame
from ..models.smpl import smpl_forward
from ..models.vposer import encode_mean
from ..viz.overlay import render_mesh_overlay

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>mvsmplfitting adjust</title>
<style>
 body { font-family: sans-serif; background: #181818; color: #ddd; }
 canvas { border: 1px solid #444; margin: 4px; cursor: crosshair; }
 #bar { position: sticky; top: 0; background: #222; padding: 8px; }
 button { margin-right: 8px; }
 .dim { color: #8cf; }
</style></head><body>
<div id="bar">
 <button id="refit">Refit (final-stage solve)</button>
 <button id="save">Save results</button>
 <span id="loss"></span>
 <div>keys: <b>a/d</b> beta&plusmn;1 (<b>s</b> cycles dim
 <span class="dim" id="sd">0</span>) &middot; <b>z/c</b> orient&plusmn;.05
 (<b>x</b> cycles <span class="dim" id="oa">0</span>) &middot;
 <b>v/n</b> transl&plusmn;.05 (<b>b</b> cycles
 <span class="dim" id="ta">0</span>) &middot; <b>q/e</b> pose&plusmn;.02
 (joint <input id="ji" type="number" value="0" min="0" max="22"
 style="width:3em"> axis <b>w</b> cycles
 <span class="dim" id="ka">0</span>) &middot; <b>r</b> reset &middot;
 drag keypoints to edit</div>
</div>
<div id="views"></div>
<script>
let state = null, drag = null;
const dims = {sd: 0, oa: 0, ta: 0, ka: 0};
async function load() {
  state = await (await fetch('/api/state')).json();
  document.getElementById('loss').textContent =
    ' loss: ' + state.loss.toFixed(2);
  const root = document.getElementById('views');
  root.innerHTML = '';
  state.views.forEach((v, vi) => {
    const c = document.createElement('canvas');
    c.width = v.width; c.height = v.height;
    c.dataset.view = vi;
    root.appendChild(c);
    const img = new Image();
    img.onload = () => { draw(c, img, vi); c._img = img; };
    img.src = 'data:image/jpeg;base64,' + v.img;
    c.onmousedown = e => {
      const r = c.getBoundingClientRect();
      const x = e.clientX - r.left, y = e.clientY - r.top;
      let best = -1, bd = 144;   /* 12px pick radius, like change() */
      state.views[vi].keypoints.forEach((k, j) => {
        const d = (k[0]-x)**2 + (k[1]-y)**2;
        if (d < bd) { bd = d; best = j; }
      });
      if (best >= 0) drag = {view: vi, joint: best, canvas: c};
    };
    c.onmousemove = e => {
      if (!drag || drag.canvas !== c) return;
      const r = c.getBoundingClientRect();
      const k = state.views[drag.view].keypoints[drag.joint];
      k[0] = e.clientX - r.left; k[1] = e.clientY - r.top;
      k[2] = Math.max(k[2], 0.9);   /* edited points become confident */
      draw(c, c._img, vi);
    };
    c.onmouseup = async e => {
      if (!drag) return;
      const k = state.views[drag.view].keypoints[drag.joint];
      await fetch('/api/keypoint', {method: 'POST', body: JSON.stringify(
        {view: drag.view, joint: drag.joint, x: k[0], y: k[1]})});
      drag = null;
    };
  });
}
function draw(c, img, vi) {
  const g = c.getContext('2d');
  g.drawImage(img, 0, 0);
  state.views[vi].keypoints.forEach(k => {
    g.fillStyle = k[2] > 0.2 ? '#f33' : '#666';
    g.beginPath(); g.arc(k[0], k[1], 4, 0, 7); g.fill();
  });
}
document.addEventListener('keydown', async e => {
  const cyc = {s: ['sd', 10], x: ['oa', 3], b: ['ta', 3], w: ['ka', 3]};
  if (cyc[e.key]) {
    const [id, m] = cyc[e.key];
    dims[id] = (dims[id] + 1) % m;
    document.getElementById(id).textContent = dims[id];
    return;
  }
  const ji = +document.getElementById('ji').value;
  const nudges = {
    a: ['betas', dims.sd, -1.0], d: ['betas', dims.sd, 1.0],
    z: ['global_orient', dims.oa, -0.05],
    c: ['global_orient', dims.oa, 0.05],
    v: ['transl', dims.ta, -0.05], n: ['transl', dims.ta, 0.05],
    q: ['body_pose', 3 * ji + dims.ka, -0.02],
    e: ['body_pose', 3 * ji + dims.ka, 0.02],
  };
  if (e.key === 'r') {
    await fetch('/api/nudge', {method: 'POST',
      body: JSON.stringify({reset: true})});
    await load(); return;
  }
  if (nudges[e.key]) {
    const [f, i, d] = nudges[e.key];
    await fetch('/api/nudge', {method: 'POST', body: JSON.stringify(
      {field: f, index: i, delta: d})});
    await load();
  }
});
document.getElementById('refit').onclick = async () => {
  document.getElementById('loss').textContent = ' solving...';
  await fetch('/api/refit', {method: 'POST'});
  await load();
};
document.getElementById('save').onclick = async () => {
  const r = await (await fetch('/api/save', {method: 'POST'})).json();
  alert('saved: ' + r.path);
};
load();
</script></body></html>"""


def _row(t: torch.Tensor) -> np.ndarray:
    """Frame 0 of a batched tensor, on the host."""
    return t.detach()[0].cpu().numpy()


class AdjustApp:
    """The session, the frame's current state and the refit."""

    def __init__(self, cfg, sess, frame, max_size: int = 640):
        self.cfg = cfg
        self.sess = sess
        self.frame = frame
        self.max_size = max_size
        self.obs = frame_to_observations(frame, sess.joint_weights,
                                         device=sess.device)
        self.img_h = float(frame.img_hw[0])

        guess = init_guess(sess.assets, sess.cameras, self.obs.gt2d,
                           self.obs.conf, self.obs.view_mask,
                           est_scale=not cfg.fix_scale)
        self.result = fit_frame(sess.fit_config, sess.assets,
                                sess.cameras, self.obs,
                                guess.params, guess.z,
                                vposer_w=sess.vposer, gmm=sess.gmm,
                                img_height=self.img_h)
        self.init_result = self.result
        # Editable image-space keypoints per view.
        self.keypoints = np.asarray(frame.keypoints[:, 0]).copy()
        # The effective full state being edited: params and the decoded
        # 69-dim body pose (under VPoser the fitted pose is in
        # result.body_pose, not params.body_pose).
        self.override = None      # {"params": SMPLParams, "body_pose"}
        self.lock = threading.Lock()

    def loss(self) -> float:
        return float(self.result.loss[0])

    def _effective(self):
        """(params, body_pose (69,)) the user currently sees."""
        if self.override is not None:
            return self.override["params"], self.override["body_pose"]
        return self.result.params, _row(self.result.body_pose)

    # -- the reference's keyboardCall (`utils.py:504-572`) -------------
    def nudge(self, field: str, index: int, delta: float):
        """Clamps as the reference's: the pose within +-0.5 and the
        orientation and translation within +-1 of the first fit, betas in
        [-10, 10] (`utils.py:508-514`)."""
        with self.lock:
            params, bp = self._effective()
            bp = np.asarray(bp).copy()
            if field == "body_pose":
                ref = float(_row(self.init_result.body_pose)[index])
                bp[index] = np.clip(bp[index] + delta,
                                    ref - 0.5, ref + 0.5)
                self.override = {"params": params, "body_pose": bp}
                return
            cur = getattr(params, field)
            arr = np.atleast_1d(_row(cur)).copy()
            if field == "betas":
                lo, hi = -10.0, 10.0
            else:               # global_orient / transl: first fit +-1
                ref = np.atleast_1d(_row(getattr(self.init_result.params,
                                                 field)))
                lo, hi = ref[index] - 1.0, ref[index] + 1.0
            arr[index] = np.clip(arr[index] + delta, lo, hi)
            val = torch.as_tensor(arr.reshape(cur.shape[1:])[None],
                                  dtype=cur.dtype, device=cur.device)
            self.override = {"params": dataclasses.replace(
                params, **{field: val}), "body_pose": bp}

    def reset(self):
        with self.lock:
            self.override = None
            self.result = self.init_result
            self.keypoints = np.asarray(self.frame.keypoints[:, 0]).copy()

    def set_keypoint(self, view: int, joint: int, x: float, y: float):
        s = self._scale(view)
        with self.lock:
            self.keypoints[view, joint, 0] = x / s
            self.keypoints[view, joint, 1] = y / s
            self.keypoints[view, joint, 2] = max(
                float(self.keypoints[view, joint, 2]), 0.9)

    def refit(self):
        with self.lock:
            dev = self.obs.gt2d.device
            kp = torch.as_tensor(self.keypoints, device=dev)[None]
            new_obs = dataclasses.replace(self.obs, gt2d=kp[..., :2],
                                          conf=kp[..., 2])
            prev = self.result
            params_override = None
            if self.override is not None:
                params_override = self.override["params"]
                bp = torch.as_tensor(self.override["body_pose"],
                                     dtype=torch.float32, device=dev)[None]
                if self.sess.fit_config.spec.use_vposer:
                    # pack() ignores params.body_pose under VPoser; the
                    # pose edit warm-starts through the encoder instead.
                    prev = dataclasses.replace(
                        prev, z=encode_mean(self.sess.vposer, bp))
                else:
                    params_override = dataclasses.replace(
                        params_override, body_pose=bp)
            self.result = refit_with_observations(
                self.sess.fit_config, self.sess.assets,
                self.sess.cameras, new_obs, prev,
                vposer_w=self.sess.vposer, gmm=self.sess.gmm,
                img_height=self.img_h,
                params_override=params_override)
            self.override = None

    def _scale(self, view: int) -> float:
        h, w = self.frame.img_hw
        return min(1.0, self.max_size / max(h, w))

    def _view(self, v: int, verts, faces, cams, keypoints) -> dict:
        img_path = self.frame.img_paths[v]
        if img_path and os.path.exists(img_path):
            img = read_image(img_path)
        else:
            h, w = self.frame.img_hw
            img = np.full((int(h), int(w), 3), 32, np.uint8)
        R, t, fo, ce = cams
        img = render_mesh_overlay(img, verts, faces, R[v], t[v], fo[v], ce[v])
        s = self._scale(v)
        if s < 1.0:
            img = resize_linear_u8_by(torch.from_numpy(img), s, s).numpy()
        return {
            "img": base64.b64encode(encode_jpeg(img, 80)).decode(),
            "width": img.shape[1], "height": img.shape[0],
            "keypoints": [[float(x * s), float(y * s), float(c)]
                          for x, y, c in keypoints[v]],
        }

    def state(self) -> dict:
        """The page's state: per view the overlay (resized to `max_size`,
        JPEG at quality 80, base64) and the keypoints in its pixels."""
        with self.lock:
            params, body_pose = self._effective()
            keypoints = self.keypoints.copy()
            loss = self.loss()
        dev = params.transl.device
        verts, _ = smpl_forward(self.sess.assets, params, torch.as_tensor(
            body_pose, dtype=torch.float32, device=dev)[None])
        verts = _row(verts)
        faces = self.sess.assets.faces.cpu().numpy()
        c = self.sess.cameras
        cams = tuple(a.detach().cpu().numpy() for a in (
            c.rotation, c.translation, c.focal, c.center))
        n = len(self.frame.img_paths)
        with ThreadPoolExecutor(max(1, min(n, os.cpu_count() or 1))) as pool:
            views = list(pool.map(
                lambda v: self._view(v, verts, faces, cams, keypoints),
                range(n)))
        return {"views": views, "loss": loss,
                "transl": _row(params.transl).tolist(),
                "scale": float(np.asarray(_row(params.scale)))}

    def save(self) -> str:
        with self.lock:
            result = self.result
        out = FitOutputs(
            betas=_row(result.params.betas),
            global_orient=_row(result.params.global_orient),
            transl=_row(result.params.transl),
            scale=_row(result.params.scale),
            body_pose=_row(result.body_pose),
            pose_embedding=_row(result.z),
            loss=float(result.loss[0]))
        path = os.path.join(self.cfg.output_folder, "adjusted",
                            self.frame.serial, self.frame.frame_name,
                            "000.pkl")
        save_result_pkl(path, out)
        return path


def make_handler(app: AdjustApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet
            pass

        def _send(self, body, ctype="application/json"):
            data = body if isinstance(body, bytes) else \
                json.dumps(body).encode()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/":
                self._send(_PAGE.encode(), "text/html; charset=utf-8")
            elif self.path == "/api/state":
                self._send(app.state())
            else:
                self.send_error(404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/api/keypoint":
                app.set_keypoint(int(body["view"]), int(body["joint"]),
                                 float(body["x"]), float(body["y"]))
                self._send({"ok": True})
            elif self.path == "/api/nudge":
                if body.get("reset"):
                    app.reset()
                else:
                    app.nudge(body["field"], int(body["index"]),
                              float(body["delta"]))
                self._send({"ok": True})
            elif self.path == "/api/refit":
                app.refit()
                self._send({"ok": True, "loss": app.loss()})
            elif self.path == "/api/save":
                self._send({"ok": True, "path": app.save()})
            else:
                self.send_error(404)

    return Handler


def build_app(args) -> AdjustApp:
    """The session of `args.config` on `args.device` and the app fitted to
    the frame `args.frame` (the first frame by default)."""
    from ..config import load_config
    from ..session import build_session

    cfg = load_config(args.config)
    sess = build_session(cfg, device=args.device)
    for f in sess.dataset:
        if args.frame in (None, f"{f.serial}/{f.frame_name}"):
            print(f"fitting {f.serial}/{f.frame_name} ...")
            return AdjustApp(cfg, sess, f)
    raise SystemExit(f"frame {args.frame} not found")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="browser adjustment GUI")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--frame", type=str, default=None,
                   help="serial/frame_name (default: first frame)")
    p.add_argument("--no_browser", action="store_true",
                   help="don't try to open a local browser tab")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the fits (default cuda; 'cpu' "
                        "runs the plain PyTorch path)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    app = build_app(args)
    print(f"adjust GUI at http://127.0.0.1:{args.port}/ "
          f"(loss {app.loss():.2f})")
    server = ThreadingHTTPServer(("127.0.0.1", args.port),
                                 make_handler(app))
    if not args.no_browser:
        try:
            import webbrowser
            webbrowser.open(f"http://127.0.0.1:{args.port}/")
        except Exception:
            pass            # headless host: the URL above still works
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
