"""Minimal FITS reader/writer.

A copy of ``africanus_tpu/utils/fits.py`` (numpy only; the port may not
import the JAX package). There is no astropy, so beam-cube IO
(utils/beams.py, testing/beam_factory.py) uses this self-contained
implementation of the FITS primary-HDU subset: 80-char header cards in
2880-byte blocks and big-endian array data, NAXIS1 fastest-varying.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_fits", "write_fits"]

_BLOCK = 2880

_BITPIX_TO_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}
_DTYPE_TO_BITPIX = {
    np.dtype(np.uint8): 8,
    np.dtype(np.int16): 16,
    np.dtype(np.int32): 32,
    np.dtype(np.int64): 64,
    np.dtype(np.float32): -32,
    np.dtype(np.float64): -64,
}


def _parse_value(text):
    text = text.strip()
    if not text:
        return None
    if text == "T":
        return True
    if text == "F":
        return False
    if text.startswith("'"):
        # FITS strings: quoted, '' escapes a quote, right-padded
        end = text.rfind("'")
        return text[1:end].replace("''", "'").rstrip()
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text.replace("D", "E").replace("d", "e"))
    except ValueError:
        return text


def read_fits(filename):
    """Read a primary-HDU FITS file → (header dict, numpy array or None)."""
    header = {}
    with open(filename, "rb") as fh:
        # header blocks until the END card
        raw = b""
        while True:
            block = fh.read(_BLOCK)
            if len(block) != _BLOCK:
                raise ValueError(f"Truncated FITS header in {filename}")
            raw += block
            # the END card is a keyword field of exactly "END" padded
            # with blanks — substring checks would trip on keywords
            # like ENDTIME or comment text ending in END, truncating
            # the header and misaligning the data offset
            cards = [raw[i : i + 80].decode("ascii") for i in
                     range(0, len(raw), 80)]
            if any(c[:8].strip() == "END" and c[8:].strip() == ""
                   for c in cards):
                break

        for card in cards:
            key = card[:8].strip()
            if not key or key in ("COMMENT", "HISTORY"):
                continue
            if key == "END":
                break
            if card[8:10] != "= ":
                continue
            body = card[10:]
            # strip inline comment (outside strings)
            if body.lstrip().startswith("'"):
                q = body.find("'", body.find("'") + 1)
                while q + 1 < len(body) and body[q + 1] == "'":
                    q = body.find("'", q + 2)
                value_text = body[: q + 1]
            else:
                value_text = body.split("/", 1)[0]
            header[key] = _parse_value(value_text)

        naxis = header.get("NAXIS", 0)
        if naxis == 0:
            return header, None
        shape = tuple(
            int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1)
        )  # C order: NAXISn slowest
        dtype = _BITPIX_TO_DTYPE[int(header["BITPIX"])]
        count = int(np.prod(shape))
        data = np.frombuffer(
            fh.read(count * dtype.itemsize), dtype=dtype, count=count
        )
        return header, data.reshape(shape).astype(dtype.newbyteorder("="))


def _format_card(key, value, comment=None):
    if isinstance(value, bool):
        text = f"{'T' if value else 'F':>20}"
    elif isinstance(value, (int, np.integer)):
        text = f"{int(value):>20d}"
    elif isinstance(value, (float, np.floating)):
        text = f"{float(value):>20.13E}"
    elif isinstance(value, str):
        quoted = "'" + value.replace("'", "''").ljust(8) + "'"
        text = f"{quoted:<20}"
    else:
        raise TypeError(f"Unhandled FITS value type {type(value)}")
    card = f"{key:<8}= {text}"
    if comment:
        card += f" / {comment}"
    return card[:80].ljust(80)


def write_fits(filename, data, cards):
    """Write a primary-HDU FITS file.

    Parameters
    ----------
    data : numpy array (written NAXIS1-fastest, i.e. C order reversed)
    cards : iterable of (key, value) or (key, value, comment); SIMPLE,
        BITPIX, NAXIS* are generated automatically.
    """
    data = np.asarray(data)
    bitpix = _DTYPE_TO_BITPIX[data.dtype]

    lines = [_format_card("SIMPLE", True, "conforms to FITS standard")]
    lines.append(_format_card("BITPIX", bitpix, "array data type"))
    lines.append(_format_card("NAXIS", data.ndim, "number of array dimensions"))
    for i in range(data.ndim):
        # NAXIS1 is the fastest-varying (last C) axis
        lines.append(_format_card(f"NAXIS{i + 1}", data.shape[data.ndim - 1 - i]))

    for card in cards:
        if len(card) == 2:
            key, value = card
            comment = None
        else:
            key, value, comment = card
        if key in ("SIMPLE", "BITPIX", "NAXIS") or (
            key.startswith("NAXIS") and key[5:].isdigit()
        ):
            continue
        lines.append(_format_card(key, value, comment))

    lines.append("END".ljust(80))
    header = "".join(lines)
    header += " " * ((-len(header)) % _BLOCK)

    payload = data.astype(data.dtype.newbyteorder(">")).tobytes()
    payload += b"\0" * ((-len(payload)) % _BLOCK)

    with open(filename, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(payload)
