"""The port's kernel build: the library key covers the shared headers,
and the two sources share the tensor-core helpers without copying them."""

from face_detection_recognization_pca_tpu_torch.ops import _build


def test_library_key_changes_with_any_header(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "kern.cu").write_text('#include "helpers.cuh"\n')
    (tmp_path / "helpers.cuh").write_text("// v1\n")
    first = _build.library_path("kern")
    assert _build.library_path("kern") == first  # unchanged sources, the same library
    (tmp_path / "helpers.cuh").write_text("// v2\n")
    second = _build.library_path("kern")
    assert second != first
    (tmp_path / "more.cuh").write_text("// new\n")
    third = _build.library_path("kern")
    assert third != second
    (tmp_path / "kern.cu").write_text('#include "helpers.cuh"\n// edited\n')
    assert _build.library_path("kern") != third


def test_both_sources_include_the_shared_helpers():
    for name in ("fused_match", "gallery_match"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "mma_sync.cuh"' in src
        for helper in ("void cp_async16(", "void ldsm_x4(", "void mma_tf32(",
                       "uint32_t rna_tf32(", "void split_tf32(", "bool beats("):
            assert helper not in src, f"{name}.cu defines {helper} again"
        assert _build.CSRC / "mma_sync.cuh" in list(_build.CSRC.glob("*.cuh"))
