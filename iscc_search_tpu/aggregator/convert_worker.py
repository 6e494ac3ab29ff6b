"""
Conversion-worker subprocess: length-prefixed pickle frames over stdio.

The poller's ConvertPool spawns this module with a private, hermetic env
(no accelerator interpreter hooks) and round-trips one ``convert_group``
call per frame. Protocol: 8-byte little-endian length prefix + pickle;
request ``(records, skip, network)``, response ``(fields, tally)``. At
startup the real stdout fd is reserved for frames and fd 1 is re-pointed
at stderr, so stray prints from imports can never corrupt the stream.
"""

from __future__ import annotations

import os
import pickle
import struct
import sys


def read_frame(stream):
    # type: (...) -> object | None
    """One pickle frame off a buffered binary stream; None on clean EOF."""
    header = stream.read(8)
    if len(header) < 8:
        return None
    (size,) = struct.unpack("<Q", header)
    payload = stream.read(size)
    if len(payload) < size:
        raise EOFError("truncated frame")
    return pickle.loads(payload)


def write_frame(stream, obj):
    # type: (..., object) -> None
    """Write one pickle frame and flush."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(struct.pack("<Q", len(payload)))
    stream.write(payload)
    stream.flush()


def serve(stdin, out):
    # type: (..., ...) -> int
    """Frame-serving loop: one convert_group call per request frame."""
    from iscc_search_tpu.aggregator.entry import convert_group

    while True:
        request = read_frame(stdin)
        if request is None:
            return 0
        records, skip, network = request
        write_frame(out, convert_group(records, skip, network))


def main():  # pragma: no cover - subprocess entry (exercised via ConvertPool)
    # type: () -> int
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)  # stray prints go to stderr, never into the frame stream
    return serve(sys.stdin.buffer, out)


if __name__ == "__main__":  # pragma: no cover - subprocess entry point
    sys.exit(main())
