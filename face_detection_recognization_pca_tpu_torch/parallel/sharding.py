"""Sharded compute: data-parallel recognition, gallery sharding and
feature-sharded PCA (port of ``parallel/sharding.py``).

The JAX package runs these under ``shard_map`` with ``psum`` and
``all_gather``.  Here the collectives are written out: each shard's
result is moved to the process's first device, and the results are
stacked or summed there in shard order, so a result does not depend on
which devices hold the shards or on their timing.  Along the other mesh
axis the JAX shards are replicas that compute the same values; this port
computes them once, on the row (or column) of the process's own entries.

On a mesh that spans processes (:func:`..distributed.global_mesh`) the
model axis lies inside each process, so gallery sharding and the sharded
PCA run whole in every process on its own row and no tensor crosses
processes.  Only :func:`dp_recognize` splits work across them: each
process recognizes the chunks it owns, and the results are gathered in
rank order (:func:`..distributed.all_gather_in_rank_order`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from face_detection_recognization_pca_tpu_torch.linalg.pca import _descending
from face_detection_recognization_pca_tpu_torch.models.eigenfaces import (
    PARAM_NAMES,
    EigenfacesModel,
    extract_features,
    recognize,
)
from face_detection_recognization_pca_tpu_torch.ops.gallery_match import gallery_match
from face_detection_recognization_pca_tpu_torch.ops.similarity import cosine_gallery
from face_detection_recognization_pca_tpu_torch.parallel.distributed import (
    all_gather_in_rank_order,
)
from face_detection_recognization_pca_tpu_torch.parallel.mesh import Mesh


def _replicate(model: EigenfacesModel, device: torch.device) -> EigenfacesModel:
    """The model with its buffers on ``device`` (shared, not copied, where
    they are there already)."""
    buffers = {
        name: None if getattr(model, name) is None else getattr(model, name).to(device)
        for name in PARAM_NAMES
    }
    return EigenfacesModel(**buffers, face_shape=model.face_shape, schema=model.schema)


def _sum_in_order(parts: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The psum: per-shard tensors added on ``device`` in shard order."""
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def _shard_cosines(feats: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
    """The ``(B, n)`` cosine matrix of the plain path.  For a float32 or
    float64 gallery, :func:`..ops.similarity.cosine_gallery` in the wider
    of the two dtypes.  For a bfloat16 gallery, the kernel's arithmetic
    (see :func:`sharded_gallery_match`): the features rounded to bfloat16
    for the dots, products and sums in float32, and float32 norms of the
    unrounded features and of the rows as stored."""
    dt = torch.promote_types(feats.dtype, shard.dtype)
    rows = shard.to(dt)
    if shard.dtype != torch.bfloat16:
        return cosine_gallery(feats.to(dt), rows)
    dots = feats.to(torch.bfloat16).to(dt) @ rows.T
    denom = (
        torch.linalg.vector_norm(feats.to(dt), dim=1, keepdim=True)
        * torch.linalg.vector_norm(rows, dim=1)[None, :]
    )
    safe = denom > 0
    return torch.where(safe, dots / torch.where(safe, denom, torch.ones_like(denom)), 0.0)


def _gather_chunks(local: Dict[int, torch.Tensor], owners: Sequence[int]) -> torch.Tensor:
    """The chunks in chunk order, each from the process that owns it.
    ``local`` maps this process's chunk positions to its results; the
    other positions are zeros in the buffer it sends."""
    sample = next(iter(local.values()))
    size = sample.shape[0]
    buf = sample.new_zeros((len(owners) * size, *sample.shape[1:]))
    for i, part in local.items():
        buf[i * size : (i + 1) * size] = part
    parts = all_gather_in_rank_order(buf)
    return torch.cat([parts[owner][i * size : (i + 1) * size] for i, owner in enumerate(owners)])


def dp_recognize(
    mesh: Mesh,
    model: EigenfacesModel,
    crops: torch.Tensor,
    threshold: float = 0.7,
    data_axis: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Data-parallel recognize: the crop batch is split into contiguous
    chunks over the ``data`` axis, each chunk is recognized on its device
    by a copy of the model there, and the results are concatenated on
    the process's first device.  On a mesh that spans processes each
    process recognizes the chunks whose entries it owns, and every process
    gets the whole batch's results.  Returns ``(person_ids,
    confidences)``."""
    devices = mesh.axis_devices(data_axis)
    owners = mesh.axis_owners(data_axis)
    b = crops.shape[0]
    if b % len(devices):
        raise ValueError(f"batch {b} not divisible by data axis {len(devices)}")
    if mesh.rank not in owners:
        raise ValueError(f"process {mesh.rank} owns no entry along {data_axis!r}")
    first = mesh.first_device
    replicas = {}
    ids, conf = {}, {}
    for i, (device, owner, chunk) in enumerate(zip(devices, owners,
                                                   torch.chunk(crops, len(devices)))):
        if owner != mesh.rank:
            continue
        if device not in replicas:
            replicas[device] = _replicate(model, device)
        chunk_ids, chunk_conf = recognize(replicas[device], chunk.to(device), threshold)
        ids[i], conf[i] = chunk_ids.to(first), chunk_conf.to(first)
    if not mesh.spans_processes:
        return torch.cat(list(ids.values())), torch.cat(list(conf.values()))
    return _gather_chunks(ids, owners), _gather_chunks(conf, owners)


def sharded_gallery_match(
    mesh: Mesh,
    feats: torch.Tensor,  # (B, k), replicated to every shard
    gallery: torch.Tensor,  # (N, k), split by rows over the model axis
    labels: torch.Tensor,  # (N,) int; negative marks an invalid row
    threshold: float = 0.7,
    model_axis: str = "model",
    use_kernel: bool = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine match against a gallery split over the ``model`` axis:
    each shard's winner, then a first-occurrence argmax over the shards.
    Returns ``(person_ids (B,), confidences (B,))`` on the process's first
    device; a confidence below ``threshold`` gives id -1.  On a mesh that
    spans processes every process matches on its own row, as the JAX
    package's replicas along the data axis do.

    N is padded to a multiple of the model axis with label -1, and the
    rows are split into contiguous shards.  Rows with a negative label,
    the padding included, never win.  With ``use_kernel`` (default: the
    first device is a CUDA device) each shard is scored by
    :func:`..ops.gallery_match.gallery_match`, invalid rows carrying the
    norm -1; it reads the shard in place, as rows of ``gallery`` in the
    gallery's dtype (float32 or bfloat16), and padding rows, which could
    only lose, are not materialised.  Without it, each shard is scored
    like the JAX package's plain path: the full cosine matrix with -inf
    on invalid rows.

    **A bfloat16 gallery** is a storage format that halves the bytes
    streamed per row.  Its semantics here, on both paths: the rows are
    used as stored; the features are rounded to bfloat16 for the dot
    products only, so that both operands feed the tensor cores as
    bfloat16; products and sums are float32; and both norms are float32,
    the features' taken before the rounding and the rows' from the stored
    values.  The two paths then differ only in float32 rounding (the
    kernel multiplies by reciprocal norms, the plain path divides by their
    product), about 1e-7 on a cosine, so ``use_kernel`` changes an id only
    between rows whose cosines are that close.  The JAX package rounds the
    other way: it keeps the features in float32 and takes the row norms in
    bfloat16, whose 8 bits of mantissa move a cosine by up to about 2e-3.
    Against float64 arithmetic on the same stored rows the semantics here
    are the closer of the two, and on random data the two packages name a
    different row for about 1% of the probes
    (``tests/test_torch_sharding.py`` pins the counts).
    """
    devices = mesh.local_axis_devices(model_axis)
    first = mesh.first_device
    if use_kernel is None:
        use_kernel = first.type == "cuda"
    n_shards = len(devices)
    n = gallery.shape[0]
    shard_n = -(-n // n_shards)
    labels = labels.to(torch.int32)
    pad = shard_n * n_shards - n
    if pad:
        labels = torch.cat([labels, labels.new_full((pad,), -1)])

    bests, labs = [], []
    for s, device in enumerate(devices):
        start, stop = s * shard_n, min(n, (s + 1) * shard_n)
        lab = labels[s * shard_n : (s + 1) * shard_n].to(device)
        f = feats.to(device)
        if stop <= start:  # a shard of padding only: every row scores -inf
            bests.append(torch.full((f.shape[0],), float("-inf"), device=device))
            labs.append(lab[torch.zeros(f.shape[0], dtype=torch.long, device=device)])
            continue
        shard = gallery[start:stop].to(device)
        valid = lab[: stop - start] >= 0
        if use_kernel:
            gnorm = torch.linalg.vector_norm(shard, dim=1, dtype=torch.float32)
            gnorm = torch.where(valid, gnorm, -1.0)
            idx, best = gallery_match(f, shard.T, gnorm, operand_dtype=shard.dtype)
            idx = idx.long()
        else:
            scores = torch.where(valid[None, :], _shard_cosines(f, shard), float("-inf"))
            idx = torch.argmax(scores, dim=1)
            best = torch.gather(scores, 1, idx[:, None])[:, 0]
        bests.append(best)
        labs.append(lab[idx])

    # The all_gather and combine: shard winners stacked (S, B) in shard
    # order on the first device; the first shard wins a tie.
    all_best = torch.stack([b.to(first) for b in bests])
    all_lab = torch.stack([lab.to(first) for lab in labs])
    winner = torch.argmax(all_best, dim=0)[None, :]
    best = torch.gather(all_best, 0, winner)[0]
    lab = torch.gather(all_lab, 0, winner)[0]
    return torch.where(best >= threshold, lab, -1), best


def snapshot_pca_sharded(
    mesh: Mesh,
    x: torch.Tensor,  # (n, d), n < d; split over features
    n_components: int,
    model_axis: str = "model",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Feature-sharded snapshot PCA, the distributed training step.

    Each shard centres its columns; the ``(n, n)`` Gram blocks are summed
    over the shards in order and ``eigh`` runs once, on the first device;
    the back-projection stays sharded, and the component norms and the
    projection are sums over the shards again.  Every process of a mesh
    that spans processes runs it whole on its own row.  Returns whole
    tensors on the process's first device: components ``(k, d)``, mean ``(d,)``, projected
    ``(n, k)`` and eigenvalues ``(k,)`` descending, with the order and
    sign semantics of :func:`..linalg.pca.snapshot_pca`.
    """
    n, d = x.shape
    devices = mesh.local_axis_devices(model_axis)
    n_shards = len(devices)
    if d % n_shards:
        raise ValueError(f"feature dim {d} not divisible by {n_shards}")
    k = min(n_components, n)
    first = mesh.first_device
    width = d // n_shards

    means, centred = [], []
    for s, device in enumerate(devices):
        xs = x[:, s * width : (s + 1) * width].to(device)
        mean = xs.mean(dim=0)
        means.append(mean)
        centred.append(xs - mean)
    gram = _sum_in_order([xc @ xc.T for xc in centred], first) / (n - 1)
    eigval, eigvec = torch.linalg.eigh(gram)  # ascending
    order = _descending(eigval)[:k]
    eigval = eigval[order]
    v = eigvec[:, order]  # (n, k)

    u = [xc.T @ v.to(xc.device) for xc in centred]  # (width, k) per shard
    norms = torch.sqrt(_sum_in_order([(us * us).sum(dim=0) for us in u], first))
    norms = torch.where(norms > 0, norms, torch.ones_like(norms))
    u = [us / norms.to(us.device) for us in u]
    proj = _sum_in_order([xc @ us for xc, us in zip(centred, u)], first)
    components = torch.cat([us.T.to(first) for us in u], dim=1)
    mean = torch.cat([m.to(first) for m in means])
    return components, mean, proj, eigval


def multichip_train_step(
    mesh: Mesh,
    images: torch.Tensor,  # (n, d)
    probe_crops: torch.Tensor,  # (B, h, w)
    n_components: int,
    face_shape: Tuple[int, int],
    data_axis: str = "data",
    model_axis: str = "model",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One training step across the mesh: feature-sharded PCA, then the
    probe batch matched against the new gallery, sharded over the model
    axis (every label is 0, the threshold 0.5).  Returns ``(ids, conf,
    eigenvalues)``.  ``data_axis`` is taken for the JAX signature; as
    there, nothing in the step is split over it, so on a mesh that spans
    processes every process runs the whole step."""
    comps, mean, proj, eigval = snapshot_pca_sharded(mesh, images, n_components, model_axis)
    model = EigenfacesModel(
        components=comps,
        projection_mean=mean,
        mean_face=mean,
        gallery=proj,
        labels=torch.zeros(proj.shape[0], dtype=torch.int32, device=proj.device),
        face_shape=tuple(face_shape),
        schema="v1",
    )
    feats = extract_features(model, probe_crops.to(comps.device))
    ids, conf = sharded_gallery_match(mesh, feats, model.gallery, model.labels, 0.5, model_axis)
    return ids, conf, eigval
