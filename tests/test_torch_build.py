"""The port's kernel builder (``repro_torch.kernels.build``) on the CPU:
library names follow the source and the flags, an edited source gets a new
name, and a failed build raises and leaves no library behind."""

import pathlib
import shutil

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.stream_rf import kernel as rf_kernel

LIBRARIES = {"stream_rf": rf_kernel.LIBRARY, "flash_attention": fa_kernel.LIBRARY,
             "ssm_scan": ssm_kernel.LIBRARY}


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_each_library_is_named_by_its_source_and_flags(name):
    lib = LIBRARIES[name]
    path = lib.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert lib.library_path() == path  # the name is stable


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_an_edited_source_gets_a_new_name(name, tmp_path):
    source = tmp_path / LIBRARIES[name].source.name
    shutil.copy(LIBRARIES[name].source, source)
    copy = build.CudaLibrary(source, lambda lib: None)
    assert copy.library_path() == LIBRARIES[name].library_path()
    source.write_text(source.read_text() + "\n// edited\n")
    assert copy.library_path() != LIBRARIES[name].library_path()


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_a_failed_build_raises_and_leaves_no_library(name, tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: shutil.which("false"))
    lib = build.CudaLibrary(LIBRARIES[name].source, lambda lib: None)
    with pytest.raises(RuntimeError, match=f"nvcc failed to build {name}.cu"):
        lib.load()
    assert not any(pathlib.Path(tmp_path).iterdir())
    with pytest.raises(RuntimeError, match="nvcc failed"):  # no stale library is loaded
        lib.load()
