"""The kernel build's cache key and the flash backward's routing, on the
CPU (no ``nvcc``, no card).

``build.target`` names each library after a hash of its source, the
shared headers ``csrc/*.cuh`` and the flags: a copy of ``csrc/`` gives
the same library paths, and one byte changed in a header or a source
gives another path, so a stale library is never reused.  The flash
backward's wrapper picks its route by dtype and D in plain code
(``bwd_route``) and sizes its scratch by route; TMA loads a view only
where ``tma_strides`` passes it (a base off 16 bytes goes to the
producer's staging).
"""
import shutil

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    return dst


def _flip_byte(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0x01
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("name", build.SOURCES)
def test_copy_of_the_sources_gives_the_same_library(csrc_copy, name):
    assert build.target(name, csrc_copy)[1] == build.target(name)[1]


@pytest.mark.parametrize("name", build.SOURCES)
def test_header_byte_changes_the_library_path(csrc_copy, name):
    headers = sorted(csrc_copy.glob("*.cuh"))
    assert [h.name for h in headers] == ["hopper.cuh", "tf32.cuh"]
    for header in headers:
        before = build.target(name, csrc_copy)[1]
        _flip_byte(header)
        assert build.target(name, csrc_copy)[1] != before


def test_source_byte_changes_only_its_library(csrc_copy):
    before = {n: build.target(n, csrc_copy)[1] for n in build.SOURCES}
    _flip_byte(csrc_copy / "flash_attention_bwd.cu")
    after = {n: build.target(n, csrc_copy)[1] for n in build.SOURCES}
    assert {n for n in build.SOURCES if before[n] != after[n]} == \
        {"flash_attention_bwd"}


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd"])
def test_flash_sources_include_the_shared_header(name):
    assert '#include "hopper.cuh"' in (build.CSRC / f"{name}.cu").read_text()


@pytest.mark.parametrize("name", ["wkv", "wkv_bwd"])
def test_wkv_sources_include_the_tf32_header(name):
    assert '#include "tf32.cuh"' in (build.CSRC / f"{name}.cu").read_text()


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "flash_attention_bwd_tc"),
    (torch.bfloat16, 80, "flash_attention_bwd_tc"),
    (torch.bfloat16, 128, "flash_attention_bwd_tc"),
    (torch.bfloat16, 129, "flash_attention_bwd_wide"),
    (torch.bfloat16, 256, "flash_attention_bwd_wide"),
    (torch.float32, 64, "flash_attention_bwd"),
    (torch.float32, 128, "flash_attention_bwd"),
    (torch.float32, 256, "flash_attention_bwd")])
def test_bwd_route_by_dtype_and_d(dtype, d, route):
    assert kflash.bwd_route(dtype, d) == route
    assert route in kflash.launches


@pytest.mark.parametrize("sq,padded", [(1, 64), (64, 64), (65, 128),
                                       (1000, 1024), (1024, 1024)])
def test_bwd_scratch_by_route(sq, padded):
    b, hq = 2, 3
    assert kflash.bwd_scratch_len(kflash.BWD_TC, b, hq, sq) == \
        2 * b * hq * padded
    for route in (kflash.BWD, kflash.BWD_WIDE):
        assert kflash.bwd_scratch_len(route, b, hq, sq) == b * hq * sq


def test_tma_refuses_a_base_off_16_bytes():
    """A ``[B, H, S, D]`` view of ``[B, S, H, D]`` passes; the same view
    one element into its buffer (as autograd may hand ``dout`` over)
    does not, and goes to the producer's plain loads."""
    b, s, h, d = 2, 40, 4, 64
    buf = torch.zeros(b * s * h * d + 1, dtype=torch.bfloat16)
    good = buf[:-1].view(b, s, h, d).transpose(1, 2)
    odd = buf[1:].view(b, s, h, d).transpose(1, 2)
    assert kflash.tma_strides(good)[1]
    assert not kflash.tma_strides(odd)[1]
    assert kflash.tma_strides(odd)[0] == kflash.tma_strides(good)[0]


def test_bwd_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kflash.flash_attention_bwd(q, q, q, q, q, lse)
