"""The serving-batch measurement that chip_smoke.py and bench.py share
(lzfse_rust_tpu/utils/serving.py): the batch it builds, its timing loop,
and the checks that fail a run. Decode and encode run on the GPU path with
the kernels interpreted, on a few corpus sources instead of 48 replicas."""

import hashlib

import pytest

from lzfse_rust_tpu.utils import serving as S


@pytest.fixture(scope="module")
def batch():
    return S.batch(0)


def _small(b, n=2):
    """The batch cut to the first n sources, twice over."""
    return dict(b, dec=b["encs"][:n] * 2,
                dec_sha=[hashlib.sha256(r).digest() for r in b["raws"][:n]]
                * 2, enc=b["raws"][:n], enc_want=b["encs"][:n])


def test_batch_is_the_serving_batch(batch):
    from lzfse_rust_tpu.runtime import native
    assert len(batch["raws"]) == 12
    assert len(batch["dec"]) == 12 * S.DECODE_REPLICAS == 576
    assert batch["dec_raw"] == 141_241_872
    assert len(batch["enc"]) == 12 * S.ENCODE_REPLICAS == 48
    assert batch["enc_raw"] == 11_770_156
    assert batch["encs"][3] == native.encode_bytes(batch["raws"][3])
    assert batch["dec_sha"][12 + 5] == hashlib.sha256(
        batch["raws"][5]).digest()


def test_warm_wall_runs_and_returns_the_last_call():
    calls = []
    out, ts = S.warm_wall(lambda: calls.append(len(calls)) or len(calls), 3)
    assert calls == [0, 1, 2, 3] and out == 4
    assert len(ts) == 3 and all(t >= 0 for t in ts)
    assert S.median([3.0, 1.0, 2.0]) == 2.0


def test_time_decode_gpu_path(batch, gpu_path):
    from lzfse_rust_tpu.models.decoder import TpuDecoder
    ts, stages = S.time_decode(TpuDecoder(), _small(batch))
    assert len(ts) == S.RUNS
    assert set(stages) == {"parse", "prep", "dispatch", "device", "flatten",
                           "rebuild"}


def test_time_encode_gpu_path(batch, gpu_path):
    from lzfse_rust_tpu.models.encoder import TpuEncoder
    assert len(S.time_encode(TpuEncoder(), _small(batch), runs=1)) == 1
    with pytest.raises(S.CheckFailed, match="differ from the native"):
        S.time_encode(TpuEncoder(), dict(_small(batch), enc_want=[b"", b""]),
                      runs=0)


class _Dec:
    last_path = "gpu"


def test_check_decode_fails_each_way(batch):
    b = _small(batch)
    outs = b["raws"][:2] * 2
    S.check_decode(_Dec(), b, outs, 0)
    with pytest.raises(S.CheckFailed, match="differ from the sources"):
        S.check_decode(_Dec(), b, outs[::-1], 0)
    with pytest.raises(S.CheckFailed, match="1 spec-layer fallbacks"):
        S.check_decode(_Dec(), b, outs, 1)
    cpu = _Dec()
    cpu.last_path = "cpu"
    with pytest.raises(S.CheckFailed, match="path 'cpu'"):
        S.check_decode(cpu, b, outs, 0)
