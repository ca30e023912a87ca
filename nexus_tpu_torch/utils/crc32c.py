"""CRC32C (Castagnoli, reflected polynomial 0x82F63B78), table-driven.

OCDBT ends every manifest and node file with the CRC32C of the bytes before
it. Those files are small (kilobytes), so a byte-at-a-time loop over a
256-entry table is enough.
"""

from __future__ import annotations

POLY = 0x82F63B78


def _table():
    out = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        out.append(c)
    return tuple(out)


TABLE = _table()


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data``, continuing from ``crc`` (the CRC of what came
    before it)."""
    table = TABLE
    c = crc ^ 0xFFFFFFFF
    for b in memoryview(data).cast("B"):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF
