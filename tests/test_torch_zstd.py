"""The port's zstd codec (``multimodal_tta_tpu_torch/csrc/zstd_decode.cpp``
through ``core/zstd.py``) against the frames tensorstore writes for a zarr v2
array with ``{"id": "zstd", "level": L}`` (the reference's orbax chunks), on
the CPU:

  - frames at levels 1, 3, 9 and 19 of zeros, random bytes, a repeating
    pattern, f32 and bf16 weights, sizes 0, 1, 128 KiB +- 1 and 1 MiB, and
    hypothesis-drawn contents decode to their source;
  - across them every literals mode (raw, RLE, Huffman with one and four
    streams, treeless, weights direct and FSE-coded) and every sequences
    mode (none, predefined, RLE, FSE, repeat) is decoded;
  - a flipped content checksum and a truncated frame raise, several frames
    and skippable frames decode (frames from the ``zstandard`` package);
  - the port's own frames (raw and RLE blocks) decode in tensorstore;
  - CRC-32C against ``google_crc32c``."""

import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from multimodal_tta_tpu_torch.core import zstd

LEVELS = (1, 3, 9, 19)


def _zarr(level: int, n: int):
    return ts.open({"driver": "zarr", "kvstore": "memory://", "metadata": {
        "shape": [n], "chunks": [n], "dtype": "|u1", "compressor": {"id": "zstd", "level": level},
        "fill_value": None}}, create=True).result()


def tensorstore_frame(data: bytes, level: int) -> bytes:
    """The chunk tensorstore writes for ``data`` (the one chunk of a 1-d
    uint8 zarr array). Tensorstore writes no chunk of 0 bytes: the empty
    content's frame is the ``zstandard`` package's."""
    if not data:
        return zstandard.ZstdCompressor(level=level).compress(b"")
    s = _zarr(level, len(data))
    s[...] = np.frombuffer(data, np.uint8)
    return s.kvstore["0"]


def _contents() -> dict:
    rng = np.random.RandomState(0)
    w = (rng.randn(200_000) * 0.05).astype(np.float32)
    base = np.frombuffer(rng.bytes(100_000), np.uint8)
    marked = base.copy()
    marked[::50] = 0xFF  # matches of the first half with one repeated literal between them
    return {
        "empty": b"", "one": b"\x07", "zeros": bytes(200_000), "random": rng.bytes(200_000),
        "pattern": b"0123456789abcdef" * 12_000, "f32": w.tobytes(),
        "bf16": torch.from_numpy(w).bfloat16().view(torch.int16).numpy().tobytes(),
        "128k-1": rng.randint(0, 8, (128 << 10) - 1).astype(np.uint8).tobytes(),
        "128k": rng.randint(0, 8, 128 << 10).astype(np.uint8).tobytes(),
        "128k+1": rng.randint(0, 8, (128 << 10) + 1).astype(np.uint8).tobytes(),
        "1m": np.cumsum(rng.randint(-2, 3, 1 << 18)).astype(np.int32).tobytes(),
        "marked": np.concatenate([base, marked]).tobytes(),
        "text": b"".join(b"%d: the quick brown fox %s\n" % (i, b"jumps" * (i % 4)) for i in range(3000)),
    }


CONTENTS = _contents()


@pytest.fixture(scope="module")
def frames():
    return {(name, level): tensorstore_frame(data, level) for name, data in CONTENTS.items() for level in LEVELS}


@pytest.mark.parametrize("level", LEVELS)
def test_tensorstore_frames_decode_to_their_source(frames, level):
    for name, data in CONTENTS.items():
        assert bytes(zstd.decompress(frames[name, level], len(data))) == data, name
        # a buffer too small for the content raises rather than cut it short
        if data:
            with pytest.raises(zstd.ZstdError):
                zstd.decompress_into(frames[name, level], bytearray(len(data) - 1))


def test_every_literal_and_sequence_mode_is_decoded(frames):
    zstd.reset_counters()
    for (name, _), frame in frames.items():
        zstd.decompress(frame, len(CONTENTS[name]))
    seen = zstd.counters()
    missing = [m for m in zstd.COUNTERS if seen[m] == 0 and m not in ("skippable_frames", "checksums")]
    assert not missing, seen


@settings(max_examples=40, deadline=None)
@given(data=st.binary(min_size=1, max_size=5000) | st.lists(st.sampled_from([b"ab", b"\x00" * 7, b"xyz!"]),
                                                            min_size=1, max_size=900).map(b"".join),
       level=st.sampled_from(LEVELS))
def test_hypothesis_contents_decode(data, level):
    assert bytes(zstd.decompress(tensorstore_frame(data, level), len(data))) == data


def test_checksum_truncation_and_several_frames():
    data = CONTENTS["text"]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    assert zstd.content_size(frame) == len(data)
    zstd.reset_counters()
    assert bytes(zstd.decompress(frame)) == data and zstd.counters()["checksums"] == 1
    bad = bytearray(frame)
    bad[-1] ^= 1
    with pytest.raises(zstd.ZstdError, match="content checksum mismatch"):
        zstd.decompress(bytes(bad))
    for cut in (1, 4, 9, len(frame) // 2, len(frame) - 5):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:cut], len(data))
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress_into(b"\x00" * 16, bytearray(16))
    # several frames, a skippable frame between them
    a, b = b"first" * 300, CONTENTS["pattern"][:50_000]
    skip = (0x184D2A53).to_bytes(4, "little") + (6).to_bytes(4, "little") + b"ignore"
    two = zstandard.ZstdCompressor(level=1).compress(a) + skip + zstandard.ZstdCompressor(level=19).compress(b)
    zstd.reset_counters()
    assert bytes(zstd.decompress(two, len(a) + len(b))) == a + b
    assert zstd.counters()["skippable_frames"] == 1 and zstd.counters()["frames"] == 2


@pytest.mark.parametrize("name", ["one", "zeros", "random", "128k-1", "128k+1", "1m"])
def test_port_frames_decode_in_tensorstore(name):
    data = CONTENTS[name]
    frame = zstd.compress(data)
    assert frame[:4] == zstd.MAGIC and zstd.content_size(frame) == len(data)
    s = _zarr(1, len(data))
    s.kvstore["0"] = frame  # the chunk as the port writes it
    assert s.read().result().tobytes() == data
    assert bytes(zstd.decompress(frame)) == data
    if name == "zeros":  # RLE blocks: a few bytes each
        assert len(frame) < 100


def test_crc32c():
    import google_crc32c

    rng = np.random.RandomState(3)
    for n in (0, 1, 7, 8, 9, 4096, 100_003):
        data = rng.bytes(n)
        assert zstd.crc32c(data) == google_crc32c.value(data)
        half = n // 2
        assert zstd.crc32c(data[half:], zstd.crc32c(data[:half])) == google_crc32c.value(data)
