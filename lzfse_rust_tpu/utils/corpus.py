"""Seeded corpus shaped like the Snappy test corpus.

The LZFSE reference benchmarks (and this repository's serving batch) use
the Snappy corpus: 12 files, 14 KB to 702 KB, 2.94 MB in all, of text,
HTML, URLs, a protocol buffer, a chess tablebase, a JPEG and a PDF. The
files themselves are not redistributable here, so `generate` builds
stand-ins from a seed: each source has its original name, its exact size,
and data of the same kind, tuned so the codec compresses it about as much
as the original (`REF_SIZE` holds the reference encoder's compressed size
of each original, from the reference README's benchmark table).
"""

from __future__ import annotations

import numpy as np

# (name, kind, raw bytes, reference compressed bytes)
SOURCES = (
    ("Mark.Twain-Tom.Sawyer.txt", "text", 14168, 6659),
    ("alice29.txt", "text", 152089, 56303),
    ("asyoulik.txt", "text", 125179, 50107),
    ("fireworks.jpeg", "jpeg", 123093, 124414),
    ("geo.protodata", "protobuf", 118588, 14554),
    ("html", "html", 102400, 14053),
    ("html_x_4", "html4", 409600, 14410),
    ("kppkn.gtb", "gaviota", 184320, 41161),
    ("lcet10.txt", "text", 426754, 144430),
    ("paper-100k.pdf", "pdf", 102400, 82212),
    ("plrabn12.txt", "text", 481861, 198304),
    ("urls.10K", "urls", 702087, 190608),
)
NAMES = tuple(s[0] for s in SOURCES)
REF_SIZE = {s[0]: s[3] for s in SOURCES}
TOTAL_BYTES = sum(s[2] for s in SOURCES)

_LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
_LETTER_P = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3,
                      4.0, 2.8, 2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0,
                      0.8, 0.15, 0.15, 0.1, 0.07])
_LETTER_P = _LETTER_P / _LETTER_P.sum()


def _vocab(rng, n: int, max_len: int = 12) -> list[bytes]:
    lens = np.minimum(rng.geometric(0.22, n) + 1, max_len)
    letters = rng.choice(_LETTERS, size=int(lens.sum()), p=_LETTER_P)
    cuts = np.concatenate(([0], np.cumsum(lens)))
    return [letters[cuts[i]:cuts[i + 1]].tobytes() for i in range(n)]


def _zipf_ids(rng, n_vocab: int, n: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n_vocab + 1) ** a
    return rng.choice(n_vocab, size=n, p=p / p.sum())


_SEPS = (b".\n\n", b". ", b", ", b"; ", b"\n", b" ")


def _text(rng, size: int, n_vocab: int = 9000, a: float = 1.0) -> bytes:
    """Prose: Zipf-distributed words, sentences and paragraphs."""
    words = _vocab(rng, n_vocab)
    caps = [w[:1].upper() + w[1:] for w in words]
    out = b""
    while len(out) < size:
        n = (size - len(out)) // 5 + 64
        ids = _zipf_ids(rng, n_vocab, n, a).tolist()
        e = rng.random(n)
        sep = np.select([e < 0.008, e < 0.06, e < 0.12, e < 0.125, e < 0.16],
                        [0, 1, 2, 3, 4], 5)
        cap = np.concatenate(([True], sep[:-1] <= 1)).tolist()
        out += b"".join([(caps if c else words)[i] + _SEPS[t] for i, c, t in
                         zip(ids, cap, sep.tolist())])
    return out[:size]


def _html(rng, size: int) -> bytes:
    """Markup: a page of nested tags with attributes around short prose."""
    tags = [b"div", b"span", b"a", b"p", b"td", b"tr", b"li", b"b", b"img"]
    attrs = [b'class="', b'id="', b'href="/', b'style="', b'src="/img/']
    vals = _vocab(rng, 120, 9)
    prose = _text(rng, 12000, 500, 1.2)
    snips = [prose[a:a + int(n)] for a, n in zip(
        rng.integers(0, len(prose) - 64, 250).tolist(),
        rng.integers(4, 48, 250))]
    out = b"<html><head><title>index</title></head><body>\n"
    while len(out) < size:
        n = (size - len(out)) // 40 + 16
        t = rng.integers(0, len(tags), n).tolist()
        na = rng.integers(0, 3, n).tolist()
        at = rng.integers(0, len(attrs), 2 * n).tolist()
        av = _zipf_ids(rng, len(vals), 2 * n, 1.3).tolist()
        snip = _zipf_ids(rng, len(snips), n, 1.4).tolist()
        out += b"".join([
            b"<" + tags[t[k]]
            + b"".join([b" " + attrs[at[2 * k + j]] + vals[av[2 * k + j]]
                        + b'"' for j in range(na[k])])
            + b">" + snips[snip[k]] + b"</" + tags[t[k]] + b">\n"
            for k in range(n)])
    return out[:size]


def _urls(rng, size: int) -> bytes:
    """One URL per line: Zipf hosts, paths from a path-word vocabulary."""
    hosts = [b"http://www." + w + b"." + tld for w, tld in zip(
        _vocab(rng, 2500, 10),
        rng.choice([b"com", b"org", b"net", b"edu", b"de", b"co.uk"],
                   2500).tolist())]
    parts = [b"/" + w for w in _vocab(rng, 9000, 10)]
    out = b""
    while len(out) < size:
        n = (size - len(out)) // 40 + 16
        h = _zipf_ids(rng, len(hosts), n, 0.9).tolist()
        k = rng.integers(1, 5, n)
        p = _zipf_ids(rng, len(parts), int(k.sum()), 0.75).tolist()
        cut = np.concatenate(([0], np.cumsum(k))).tolist()
        ext = (rng.random(n) < 0.3).tolist()
        out += b"".join([
            hosts[h[i]] + b"".join([parts[j] for j in p[cut[i]:cut[i + 1]]])
            + (b".html\n" if ext[i] else b"\n") for i in range(n)])
    return out[:size]


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    out.append(v)
    return bytes(out)


def _protobuf(rng, size: int) -> bytes:
    """Serialized records: tagged varint fields with skewed values and
    repeated short strings (geo.protodata's shape)."""
    strs = _vocab(rng, 24, 8)
    pools = [[_varint(int(v)) for v in rng.integers(0, 1 << 14, 8)]
             for _ in range(8)]
    out = b""
    while len(out) < size:
        n = (size - len(out)) // 24 + 16
        vi = _zipf_ids(rng, 8, 8 * n, 2.8).reshape(n, 8).tolist()
        si = _zipf_ids(rng, len(strs), n, 1.5).tolist()
        recs = []
        for r in range(n):
            body = b"".join([bytes([f << 3 | 0]) + pools[f][vi[r][f]]
                             for f in range(8)])
            s = strs[si[r]]
            body += b"\x4a" + bytes([len(s)]) + s
            recs.append(b"\x0a" + bytes([len(body)]) + body)
        out += b"".join(recs)
    return out[:size]


def _gaviota(rng, size: int) -> bytes:
    """Tablebase-like bytes: a small skewed alphabet in runs, with earlier
    stretches recurring."""
    alpha = np.array([0, 1, 2, 3, 4, 8, 16, 32, 64, 128, 255], np.uint8)
    p = np.array([30, 14, 12, 9, 7, 6, 6, 5, 4, 4, 3], float)
    syms = rng.choice(alpha, size=size, p=p / p.sum())
    fresh = np.repeat(syms, np.minimum(rng.geometric(0.45, size), 12))
    out = bytearray(fresh[:4096].tobytes())
    at = 4096
    while len(out) < size:
        n = int(rng.integers(16, 96))
        if rng.random() < 0.6:
            src = int(rng.integers(0, len(out) - n))
            out += out[src:src + n]
        else:
            out += fresh[at:at + n].tobytes()
            at += n
    return bytes(out[:size])


def _jpeg(rng, size: int) -> bytes:
    """Entropy-coded image data: a short header, then incompressible."""
    head = b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
    return (head + rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            )[:size]


def _pdf(rng, size: int) -> bytes:
    """Deflate streams (incompressible) between short object headers."""
    prose = _text(rng, 20000, 300, 1.2)
    out = bytearray(b"%PDF-1.4\n")
    n = 1
    while len(out) < size:
        out += (b"%d 0 obj\n<< /Length %d /Filter /FlateDecode >>\nstream\n"
                % (n, 2048))
        out += rng.integers(0, 256, int(rng.integers(1200, 2400)),
                            dtype=np.uint8).tobytes()
        at = int(rng.integers(0, len(prose) - 420))
        out += b"\nendstream\nendobj\n" + prose[at:at + 420]
        n += 1
    return bytes(out[:size])


def _make(kind: str, rng, size: int) -> bytes:
    if kind == "text":
        return _text(rng, size)
    if kind == "html":
        return _html(rng, size)
    if kind == "html4":
        return _html(rng, size // 4) * 4
    return {"urls": _urls, "protobuf": _protobuf, "gaviota": _gaviota,
            "jpeg": _jpeg, "pdf": _pdf}[kind](rng, size)


def generate(seed: int = 0, names=None) -> list[tuple[str, bytes]]:
    """[(name, raw bytes)] for the corpus (or the named subset), in SOURCES
    order. Each source draws from its own stream of `seed`, so a subset
    holds the same bytes as the full corpus."""
    out = []
    for i, (name, kind, size, _) in enumerate(SOURCES):
        if names is None or name in names:
            rng = np.random.default_rng([seed, i])
            data = _make(kind, rng, size)
            assert len(data) == size, (name, len(data))
            out.append((name, data))
    return out
