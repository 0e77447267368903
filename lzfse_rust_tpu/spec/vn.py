"""LZVN (Vxn) block codec — exact scalar spec.

Block: 12-byte header {magic, n_raw_bytes, n_payload_bytes} followed by an
opcode stream terminated by an 8-byte EOS tag [0x06, 0*7]. The opcode space is
dispatched on the first byte (reference src/vn/constants.rs:38-72); individual
op layouts are documented in src/vn/opc.rs.
"""

from __future__ import annotations

import numpy as np

from ..base import constants as C
from ..base.errors import PayloadOverflow, PayloadUnderflow, VnError
from .lz import LzSink

# Op kinds, dispatched on the first opcode byte.
SML_D, MED_D, LRG_D, PRE_D, SML_M, LRG_M, SML_L, LRG_L, NOP, EOS_OP, UDEF = range(11)


def _build_op_table() -> np.ndarray:
    """Derive the 256-entry first-byte dispatch table from the opcode grammar.

    Matches OP_TABLE (src/vn/constants.rs:38-72): low 3 bits 110 -> PreD
    (except specials), 111 -> LrgD, 0xE0/0xF0 -> LrgL/LrgM, 0xEx/0xFx ->
    SmlL/SmlM, 101xxxxx -> MedD, 0x70-0x7F and 0xD0-0xDF -> Udef, byte 0x06 ->
    EOS, 0x0E/0x16 -> Nop, 0x1E..0x3E (step 8) -> Udef, else SmlD.
    """
    table = np.full(256, SML_D, dtype=np.int32)
    for b in range(256):
        low3 = b & 0x07
        if 0xE0 <= b <= 0xEF:
            table[b] = LRG_L if b == 0xE0 else SML_L
        elif 0xF0 <= b <= 0xFF:
            table[b] = LRG_M if b == 0xF0 else SML_M
        elif 0xA0 <= b <= 0xBF:
            table[b] = MED_D
        elif 0x70 <= b <= 0x7F or 0xD0 <= b <= 0xDF:
            table[b] = UDEF
        elif low3 == 7:
            table[b] = LRG_D
        elif low3 == 6:
            if b == 0x06:
                table[b] = EOS_OP
            elif b in (0x0E, 0x16):
                table[b] = NOP
            elif b in (0x1E, 0x26, 0x2E, 0x36, 0x3E):
                table[b] = UDEF
            else:
                table[b] = PRE_D
        else:
            table[b] = SML_D
    return table


OP_TABLE = _build_op_table()


def decode_vn(payload: bytes, n_raw_bytes: int, n_payload_bytes: int,
              sink: LzSink) -> None:
    """Decode one Vxn opcode stream into `sink`.

    `payload` is the slice following the 12-byte header; exactly
    `n_payload_bytes` of it (including the 8-byte EOS tag) must be consumed and
    exactly `n_raw_bytes` produced (vn_core.rs:77-116 cross-validation).
    """
    i = 0
    raw_start = len(sink)
    match_distance = 0
    limit = len(payload)
    while True:
        if i + 8 > limit:
            raise PayloadUnderflow("vn payload underflow")
        opu = int.from_bytes(payload[i:i + 4], "little")
        op = int(OP_TABLE[opu & 0xFF])
        if op == EOS_OP:
            if payload[i:i + 8] != bytes([C.VN_EOS_BYTE] + [0] * 7):
                raise VnError("BadPayload", "bad EOS tag")
            i += 8
            break
        if op == UDEF:
            raise VnError("BadOpcode")
        if op == NOP:
            i += 1
            continue
        if op == SML_L:
            l, consumed = opu & 0xF, 1
            _literals(sink, payload, i + consumed, l)
            i += consumed + l
            continue
        if op == LRG_L:
            l, consumed = ((opu >> 8) & 0xFF) + 0x10, 2
            _literals(sink, payload, i + consumed, l)
            i += consumed + l
            continue
        if op == SML_M:
            m, consumed = opu & 0xF, 1
            _match(sink, m, match_distance)
            i += consumed
            continue
        if op == LRG_M:
            m, consumed = ((opu >> 8) & 0xFF) + 0x10, 2
            _match(sink, m, match_distance)
            i += consumed
            continue
        if op == PRE_D:
            m = ((opu >> 3) & 0x7) + 3
            l = (opu >> 6) & 0x3
            consumed = 1
            d = match_distance
        elif op == SML_D:
            d = ((opu & 0x7) << 8) | ((opu >> 8) & 0xFF)
            m = ((opu >> 3) & 0x7) + 3
            l = (opu >> 6) & 0x3
            consumed = 2
        elif op == MED_D:
            m = (((opu & 0x7) << 2) | ((opu >> 8) & 0x3)) + 3
            l = (opu >> 3) & 0x3
            d = (opu >> 10) & 0x3FFF
            consumed = 3
        else:  # LRG_D
            m = ((opu >> 3) & 0x7) + 3
            l = (opu >> 6) & 0x3
            d = (opu >> 8) & 0xFFFF
            consumed = 3
        _literals(sink, payload, i + consumed, l)
        _match(sink, m, d)
        match_distance = d
        i += consumed + l
    if i != n_payload_bytes:
        if i < n_payload_bytes:
            raise PayloadOverflow("vn trailing payload")
        raise PayloadUnderflow("vn payload overrun")
    if len(sink) - raw_start != n_raw_bytes:
        raise VnError("BadPayload", "raw byte count mismatch")


def _literals(sink: LzSink, payload: bytes, start: int, n: int) -> None:
    if start + n + 8 > len(payload):
        raise PayloadUnderflow("vn literal underflow")
    sink.write_bytes(payload[start:start + n])


def _match(sink: LzSink, match_len: int, match_distance: int) -> None:
    sink.write_match(match_len, match_distance)


def parse_vn_rows(payload: bytes, n_raw_bytes: int, n_payload_bytes: int
                  ) -> tuple[np.ndarray, bytes]:
    """Parse a Vxn opcode stream into (rows, literal_pool) without executing
    the LZ copies — the host-side front half of the batched decode pipeline.

    Rows are (literal_len, match_len, d_effective) with previous-distance ops
    already resolved (the in-block equivalent of substitute). Invalid
    distances (0 or out of range) are left for the device rebuild's validity
    check; structural errors raise like decode_vn.
    """
    rows: list[tuple[int, int, int]] = []
    lits = bytearray()
    i = 0
    match_distance = 0
    n_raw = 0
    limit = len(payload)
    while True:
        if i + 8 > limit:
            raise PayloadUnderflow("vn payload underflow")
        opu = int.from_bytes(payload[i:i + 4], "little")
        op = int(OP_TABLE[opu & 0xFF])
        if op == EOS_OP:
            if payload[i:i + 8] != bytes([C.VN_EOS_BYTE] + [0] * 7):
                raise VnError("BadPayload", "bad EOS tag")
            i += 8
            break
        if op == UDEF:
            raise VnError("BadOpcode")
        if op == NOP:
            i += 1
            continue
        if op in (SML_L, LRG_L):
            l = (opu & 0xF) if op == SML_L else ((opu >> 8) & 0xFF) + 0x10
            consumed = 1 if op == SML_L else 2
            if i + consumed + l + 8 > limit:
                raise PayloadUnderflow("vn literal underflow")
            lits += payload[i + consumed:i + consumed + l]
            rows.append((l, 0, 0))
            n_raw += l
            i += consumed + l
            continue
        if op in (SML_M, LRG_M):
            m = (opu & 0xF) if op == SML_M else ((opu >> 8) & 0xFF) + 0x10
            rows.append((0, m, match_distance))
            n_raw += m
            i += 1 if op == SML_M else 2
            continue
        if op == PRE_D:
            m = ((opu >> 3) & 0x7) + 3
            l = (opu >> 6) & 0x3
            consumed, d = 1, match_distance
        elif op == SML_D:
            d = ((opu & 0x7) << 8) | ((opu >> 8) & 0xFF)
            m = ((opu >> 3) & 0x7) + 3
            l = (opu >> 6) & 0x3
            consumed = 2
        elif op == MED_D:
            m = (((opu & 0x7) << 2) | ((opu >> 8) & 0x3)) + 3
            l = (opu >> 3) & 0x3
            d = (opu >> 10) & 0x3FFF
            consumed = 3
        else:  # LRG_D
            m = ((opu >> 3) & 0x7) + 3
            l = (opu >> 6) & 0x3
            d = (opu >> 8) & 0xFFFF
            consumed = 3
        if i + consumed + l + 8 > limit:
            raise PayloadUnderflow("vn literal underflow")
        lits += payload[i + consumed:i + consumed + l]
        rows.append((l, m, d))
        match_distance = d
        n_raw += l + m
        i += consumed + l
    if i != n_payload_bytes:
        if i < n_payload_bytes:
            raise PayloadOverflow("vn trailing payload")
        raise PayloadUnderflow("vn payload overrun")
    if n_raw != n_raw_bytes:
        raise VnError("BadPayload", "raw byte count mismatch")
    return (np.array(rows, dtype=np.int32).reshape(-1, 3), bytes(lits))


# --- Encode -------------------------------------------------------------------------

def _match_len_x(literal_len: int) -> int:
    return 0x0A - 2 * literal_len


class VnEncoder:
    """LZVN opcode emitter, mirroring VnBackend (src/vn/backend.rs:37-135)."""

    def __init__(self):
        self.out = bytearray()
        self.match_distance = 0
        self.n_literals = 0
        self.n_match_bytes = 0

    def push_literals(self, literals: bytes) -> None:
        self.n_literals += len(literals)
        pos = 0
        n = len(literals)
        while n - pos >= 0x10:
            take = min(n - pos, 0x10F)
            self.out += bytes([0xE0, take - 0x10]) + literals[pos:pos + take]
            pos += take
        if n - pos > 0:
            take = n - pos
            self.out.append(0xE0 | take)
            self.out += literals[pos:pos + take]

    def push_match(self, literals: bytes, match_len: int,
                   match_distance: int) -> None:
        self.n_literals += len(literals)
        self.n_match_bytes += match_len
        pos, n = 0, len(literals)
        while n - pos >= 0x10:
            take = min(n - pos, 0x10F)
            self.out += bytes([0xE0, take - 0x10]) + literals[pos:pos + take]
            pos += take
        if n - pos >= 0x04:
            take = n - pos
            self.out.append(0xE0 | take)
            self.out += literals[pos:pos + take]
            pos += take
        literal_len = n - pos
        tail = literals[pos:]
        m = min(_match_len_x(literal_len), match_len)
        match_len -= m
        if match_distance == self.match_distance:
            if literal_len == 0:
                self.out.append(0xF0 | m)
            else:  # PreD - LLMMM110
                self.out.append((literal_len << 6) | ((m - 3) << 3) | 0x6)
                self.out += tail
        elif match_distance < 0x600:  # SmlD
            self.out.append((literal_len << 6) | ((m - 3) << 3)
                            | ((match_distance >> 8) & 0x7))
            self.out.append(match_distance & 0xFF)
            self.out += tail
        elif (match_distance >= 0x4000 or match_len == 0
                or m + match_len > 0x22):  # LrgD
            self.out.append((literal_len << 6) | ((m - 3) << 3) | 0x7)
            self.out += match_distance.to_bytes(2, "little")
            self.out += tail
        else:  # MedD - 101LLMMM DDDDDDMM DDDDDDDD
            mm = m - 3
            b0 = 0xA0 | (literal_len << 3) | ((mm >> 2) & 0x7)
            rest = ((mm & 0x3) | (match_distance << 2)) & 0xFFFF
            self.out.append(b0)
            self.out += rest.to_bytes(2, "little")
            self.out += tail
        self.match_distance = match_distance
        while match_len > 0x0F:
            take = min(match_len, 0x10F)
            self.out += bytes([0xF0, take - 0x10])
            match_len -= take
        if match_len > 0:
            self.out.append(0xF0 | match_len)

    def finalize(self) -> bytes:
        """Append EOS and the 12-byte header; returns the complete Vxn block."""
        self.out += bytes([C.VN_EOS_BYTE] + [0] * 7)
        header = (C.MAGIC_VXN.to_bytes(4, "little")
                  + (self.n_literals + self.n_match_bytes).to_bytes(4, "little")
                  + len(self.out).to_bytes(4, "little"))
        return header + bytes(self.out)
