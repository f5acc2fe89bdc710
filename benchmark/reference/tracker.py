"""The multi-stream tracker from its definition: per stream, the
TM_CCOEFF_NORMED map of the template over the search window at the
stream's origin, its first maximum, the template-sized crop there matched
by cosine against a snapshot-PCA model's gallery, and the window
re-centred on the hit for the next frame."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .eigenfaces import Model, cosines
from .numerics import Arith, no_tf32


def ncc_maps(windows: torch.Tensor, template: torch.Tensor, ar: Arith) -> torch.Tensor:
    """``(S, o, o)`` TM_CCOEFF_NORMED scores of ``template`` (t, t) over
    ``windows`` (S, n, n), o = n - t + 1: the correlation of the zero-mean
    template with each patch over the root of the template's energy times
    the patch's variance; 0 where that variance is under one grey level
    per pixel, and clamped into [-1, 1].  Each window is centred on its
    own mean first, which changes no score."""
    t = template.shape[-1]
    n = windows.shape[-1]
    o = n - t + 1
    w = windows.to(ar.single)
    w = w - w.mean(dim=(1, 2), keepdim=True)
    t0 = template.to(ar.single)
    t0 = t0 - t0.mean()
    with no_tf32():
        num = F.conv2d(ar.operand(w)[:, None], ar.operand(t0)[None, None])[:, 0].to(ar.single)
    band = ((torch.arange(n)[:, None] >= torch.arange(o)[None])
            & (torch.arange(n)[:, None] < torch.arange(o)[None] + t)).to(w.device)
    band = band.to(ar.single)
    s1 = ar.mm(ar.mm(band.T, w).to(ar.single), band).to(ar.single)
    s2 = ar.mm(ar.mm(band.T, w * w).to(ar.single), band).to(ar.single)
    count = t * t
    var = torch.clamp(s2 - s1 * s1 / count, min=0.0)
    energy = (t0 * t0).sum()
    safe = var > count
    score = num / torch.sqrt(energy * torch.where(safe, var, torch.ones_like(var)))
    return torch.clamp(torch.where(safe, score, 0.0), -1.0, 1.0)


def track(frames: torch.Tensor, template: np.ndarray, origin0: np.ndarray, model: Model,
          win: int, ar: Arith, block: int = 128) -> Dict[str, np.ndarray]:
    """Track every stream over the frames ``frames`` (P, S, H, W) hold, in
    steps 0..P: step j reads frame ``j % P``, step 0 at ``origin0`` (S, 2)
    of (y, x), every later step at the origin the step before it found.

    Returns numpy arrays with a leading step axis of P + 1: ``origin``
    (S, 2), ``scores`` (S, o*o) float64, ``best`` (S,) the first maximum's
    flat index, and ``cos`` (S, n) float64 cosines of that crop with the
    gallery; and ``next``, the origins the last step found."""
    pool, streams, fh, fw = frames.shape
    tpl = template.shape[0]
    o = win - tpl + 1
    pad = (win - tpl) // 2
    device = frames.device
    t = torch.from_numpy(np.ascontiguousarray(template)).to(device)
    ar_win = torch.arange(win, device=device)
    ar_tpl = torch.arange(tpl, device=device)
    origin = torch.from_numpy(np.ascontiguousarray(origin0)).to(device, torch.int64)
    out: Dict[str, List[np.ndarray]] = {"origin": [], "scores": [], "best": [], "cos": []}
    for step in range(pool + 1):
        frame = frames[step % pool]
        oy = origin[:, 0].clamp(0, fh - win)
        ox = origin[:, 1].clamp(0, fw - win)
        scores, best, cos = [], [], []
        for s0 in range(0, streams, block):
            sl = slice(s0, s0 + block)
            idx = torch.arange(s0, min(s0 + block, streams), device=device)[:, None, None]
            windows = frame[idx, (oy[sl, None] + ar_win)[:, :, None],
                            (ox[sl, None] + ar_win)[:, None, :]].to(torch.float64)
            maps = ncc_maps(windows, t, ar).reshape(len(idx), -1)
            loc = torch.argmax(maps, dim=1)
            ly, lx = loc // o, loc % o
            rows = (ly[:, None] + ar_tpl)[:, :, None]
            cols = (lx[:, None] + ar_tpl)[:, None, :]
            crops = windows[torch.arange(len(idx), device=device)[:, None, None], rows, cols]
            scores.append(maps.to(torch.float64))
            best.append(loc)
            cos.append(cosines(model, crops.reshape(len(idx), -1), ar).to(torch.float64))
        scores, best, cos = torch.cat(scores), torch.cat(best), torch.cat(cos)
        out["origin"].append(torch.stack([oy, ox], 1).cpu().numpy())
        out["scores"].append(scores.cpu().numpy())
        out["best"].append(best.cpu().numpy())
        out["cos"].append(cos.cpu().numpy())
        hit_y, hit_x = oy + best // o, ox + best % o
        origin = torch.stack([(hit_y - pad).clamp(0, fh - win), (hit_x - pad).clamp(0, fw - win)], 1)
    result = {key: np.stack(value) for key, value in out.items()}
    result["next"] = origin.cpu().numpy()
    return result


def judge(answers: np.ndarray, steps: np.ndarray, ref: Dict[str, np.ndarray], labels: np.ndarray,
          win: int, tpl: int) -> Dict[str, float]:
    """The program's answers against the reference's steps.

    ``answers`` (C, 6, S) int32 holds per call and stream the gallery row,
    the person id, x, y, and the cosine and template score bit-cast;
    ``steps`` (C,) the reference step each call stands for.  Returns the
    largest over all answers of

    - ``ncc_err``: how far the reference's score at the program's place
      lies below the reference's best, or the program's template score
      from the reference's score there, whichever is larger (2 for a place
      outside the reference's window);
    - ``match_err``: the same for the gallery row and its cosine, and 1
      where the person id is not the row's label."""
    o = win - tpl + 1
    ncc_err = match_err = 0.0
    for step in np.unique(steps):
        a = answers[steps == step]
        rows, pid, x, y = (a[:, i].astype(np.int64) for i in range(4))
        conf = a[:, 4].view(np.float32).astype(np.float64)
        tm = a[:, 5].view(np.float32).astype(np.float64)
        origin = ref["origin"][step]  # (S, 2)
        stream = np.arange(origin.shape[0])[None, :]
        ly, lx = y - origin[None, :, 0], x - origin[None, :, 1]
        inside = (ly >= 0) & (ly < o) & (lx >= 0) & (lx < o)
        scores = ref["scores"][step]  # (S, o*o)
        s = np.where(inside, scores[stream, np.where(inside, ly * o + lx, 0)], -1.0)
        best = scores[np.arange(origin.shape[0]), ref["best"][step]][None, :]
        ncc_err = max(ncc_err, float(np.maximum(best - s, np.abs(tm - s)).max()))
        cos = ref["cos"][step]  # (S, n)
        valid = (rows >= 0) & (rows < cos.shape[1])
        c = np.where(valid, cos[stream, np.where(valid, rows, 0)], -1.0)
        match = np.maximum(cos.max(axis=1)[None, :] - c, np.abs(conf - c))
        named = valid & (pid == labels[np.where(valid, rows, 0)])
        match_err = max(match_err, float(np.where(named, match, np.maximum(match, 1.0)).max()))
    return {"ncc_err": ncc_err, "match_err": match_err}
