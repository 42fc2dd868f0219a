"""The kernel build of sparsex_tpu_torch (``ops/_build.py``) on the CPU.

A stand-in ``nvcc`` (a shell script under a temporary ``CUDA_HOME``) writes
each ``-o`` target and fails at the step a case names: the build runs one
compile per source together, then one link, moves the library into place
only when every step succeeded, and leaves no object or partial library
behind when a step fails or times out.
"""

import os
import stat

import pytest

from sparsex_tpu_torch.ops import _build

FAKE_NVCC = r"""#!/bin/sh
out=""
prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"
done
echo "nvcc $*"
echo partial > "$out"
case "$FAKE_NVCC_FAIL" in
  compile) case "$*" in *route.cu*) echo "route.cu: error"; exit 2;; esac ;;
  link) case " $* " in *" -shared "*) echo "link step failed"; exit 1;; esac ;;
  hang) exec sleep 30 ;;
esac
exit 0
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "build_log", "")
    monkeypatch.setattr(_build, "build_seconds", None)
    return tmp_path / "build"


@pytest.mark.parametrize("fail,match", [
    (None, None),
    ("compile", "route.cu: error"),
    ("link", "link step failed"),
    ("hang", "did not run to its end"),
])
def test_compile_leaves_only_a_whole_library(fake_nvcc, monkeypatch, fail,
                                             match):
    assert len(_build.sources()) >= 2
    monkeypatch.setattr(_build, "BUILD_TIMEOUT_S", 2)
    if fail:
        monkeypatch.setenv("FAKE_NVCC_FAIL", fail)
    out = str(fake_nvcc / "libspx_kernels_test.so")
    if fail is None:
        _build._compile(out)
        assert os.listdir(fake_nvcc) == [os.path.basename(out)]
        # one compile per source, then the link over their objects
        assert _build.build_log.count(" -c ") == len(_build.sources())
        assert _build.build_log.count(" -shared ") == 1
    else:
        with pytest.raises(_build.KernelBuildError, match=match):
            _build._compile(out)
        assert os.listdir(fake_nvcc) == []
