"""Checks shared by the port's app tests.  Imports no JAX."""

import os

import numpy as np


def same_artifact(a, b, sign=True, rel=1e-9):
    """Two eigenfaces artifacts agree: metadata equal, float arrays within
    ``rel`` of each array's largest magnitude, components and features up
    to the sign of a component (``sign``)."""
    assert a.n_components == b.n_components and tuple(a.face_shape) == tuple(b.face_shape)
    assert a.person_id_map == b.person_id_map
    assert None in (a.person_name, b.person_name) or a.person_name == b.person_name
    np.testing.assert_array_equal(np.asarray(a.labels), np.asarray(b.labels))
    s = np.sign(np.sum(a.components * b.components, axis=1)) if sign else 1.0
    for x, y in ((a.components * np.reshape(s, (-1, 1)), b.components),
                 (a.features * np.reshape(s, (1, -1)), b.features),
                 (a.mean_face, b.mean_face), (a.scaler_mean, b.scaler_mean),
                 (a.scaler_scale, b.scaler_scale),
                 (a.explained_variance_ratio, b.explained_variance_ratio)):
        np.testing.assert_allclose(x, y, rtol=0, atol=rel * np.abs(y).max())
    assert [r["image_filename"] for r in a.face_info] == [r["image_filename"] for r in b.face_info]


def listing(root):
    """Every file under ``root``, relative, sorted."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)
