"""rtl_tcp client source — live RTL-SDR ingestion over the network.

The reference's flagship entry point is a live radio: ``sdrStream`` opens
an RTL2832U device, applies ``RTLSDRParams`` (center frequency, sample
rate, frequency correction, optional manual tuner gain) and streams u8 IQ
blocks from an async reader thread through a mailbox
(hs_sources/SDR/RTLSDRStream.hs:27-87).  An accelerator host has no USB radio;
the standard network front end for an RTL-SDR is the ``rtl_tcp`` server
(shipped with librtlsdr), which speaks a tiny public protocol:

* server -> client on connect: a 12-byte header — magic ``b"RTL0"``,
  then big-endian u32 tuner type and u32 tuner-gain count;
* client -> server: 5-byte commands ``struct.pack(">BI", cmd, arg)``
  (0x01 set frequency [Hz], 0x02 set sample rate [Hz], 0x03 gain mode
  manual?, 0x04 tuner gain [tenths of dB], 0x05 frequency correction
  [ppm], 0x08 tuner AGC on?);
* then a continuous raw stream of interleaved u8 IQ samples.

``rtl_tcp_source`` is therefore the exact ``sdrStream`` analog: it
configures the radio and returns a block producer backed by a reader
thread and a bounded mailbox (drop-with-count on overrun, the live-source
discipline of io/native.py's UDP ring).  Feed its blocks to
``IqConvertU8``/``U8FrontEnd`` exactly like recorded files.
"""

from __future__ import annotations

import socket
import struct
import threading
from collections import deque
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["RtlTcpParams", "RtlTcpSource", "rtl_tcp_source",
           "parse_rtl_tcp_url", "TUNER_NAMES"]

# command bytes from the rtl_tcp protocol (rtl_tcp.c command switch)
CMD_SET_FREQ = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03
CMD_SET_GAIN = 0x04
CMD_SET_FREQ_CORRECTION = 0x05
CMD_SET_AGC_MODE = 0x08

#: tuner type codes from the connect header (rtlsdr_get_tuner_type)
TUNER_NAMES = {0: "UNKNOWN", 1: "E4000", 2: "FC0012", 3: "FC0013",
               4: "FC2580", 5: "R820T", 6: "R828D"}


@dataclass
class RtlTcpParams:
    """RTLSDRParams analog (RTLSDRStream.hs:27-38): ``tuner_gain`` in
    tenths of dB; ``None`` selects hardware AGC (gain mode auto), exactly
    the reference's ``Maybe Int32`` split (RTLSDRStream.hs:48-50)."""

    center_freq: int
    sample_rate: int
    freq_correction: int = 0
    tuner_gain: Optional[int] = None


def parse_rtl_tcp_url(url: str) -> Tuple[str, int]:
    """'rtl_tcp://host:port' (or 'host:port') -> (host, port)."""
    rest = url[len("rtl_tcp://"):] if url.startswith("rtl_tcp://") else url
    host, _, port = rest.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"expected rtl_tcp://host:port, got {url!r}")
    return host, int(port)


class RtlTcpSource:
    """Connected rtl_tcp client: configures the radio, then iterates u8
    IQ blocks of exactly ``block`` items.

    A reader thread drains the socket into a bounded mailbox of complete
    blocks (``n_buffers`` deep).  When the consumer falls behind a live
    radio, the oldest buffered block is dropped and counted
    (:attr:`dropped`) — backpressure would overflow the server instead.
    Iteration ends when the server closes the connection.
    """

    def __init__(self, host: str, port: int, params: RtlTcpParams,
                 block: int, n_buffers: int = 8,
                 connect_timeout: float = 10.0):
        if block <= 0 or block % 2:
            raise ValueError("block must be a positive even item count")
        self.block = int(block)
        self.params = params
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        header = self._recv_exact(12)
        if header is None or header[:4] != b"RTL0":
            self._sock.close()
            raise ConnectionError(
                f"{host}:{port} is not an rtl_tcp server (bad magic)")
        self.tuner_type, self.tuner_gain_count = struct.unpack(
            ">II", header[4:])
        self._configure(params)
        self._mailbox: deque = deque()
        self._lock = threading.Lock()
        self._avail = threading.Semaphore(0)
        self._dropped = 0
        self._closed = False
        self._eof = False
        self._n_buffers = int(n_buffers)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    # -- control channel ---------------------------------------------------

    def _cmd(self, cmd: int, arg: int) -> None:
        self._sock.sendall(struct.pack(">BI", cmd, arg & 0xFFFFFFFF))

    def _configure(self, p: RtlTcpParams) -> None:
        """setRTLSDRParams analog (RTLSDRStream.hs:41-51)."""
        self._cmd(CMD_SET_SAMPLE_RATE, p.sample_rate)
        self._cmd(CMD_SET_FREQ, p.center_freq)
        if p.freq_correction:
            self._cmd(CMD_SET_FREQ_CORRECTION, p.freq_correction)
        if p.tuner_gain is None:
            self._cmd(CMD_SET_GAIN_MODE, 0)
            self._cmd(CMD_SET_AGC_MODE, 1)
        else:
            self._cmd(CMD_SET_GAIN_MODE, 1)
            self._cmd(CMD_SET_GAIN, p.tuner_gain)

    def set_frequency(self, hz: int) -> None:
        """Retune while streaming (the protocol allows live commands)."""
        self._cmd(CMD_SET_FREQ, hz)

    # -- data path ---------------------------------------------------------

    def _recv_exact(self, n: int) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self._sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf.extend(chunk)
        return bytes(buf)

    def _read_loop(self) -> None:
        while not self._closed:
            data = self._recv_exact(self.block)
            if data is None:
                break
            blk = np.frombuffer(data, dtype=np.uint8)
            with self._lock:
                if len(self._mailbox) >= self._n_buffers:
                    self._mailbox.popleft()
                    self._dropped += 1
                    # the popped block's semaphore permit is consumed by
                    # the push below, keeping permits == queue length
                    self._avail.acquire(blocking=False)
                self._mailbox.append(blk)
            self._avail.release()
        self._eof = True
        self._avail.release()  # wake a blocked consumer for EOF

    @property
    def dropped(self) -> int:
        """Blocks discarded because the consumer fell behind."""
        return self._dropped

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            self._avail.acquire()
            with self._lock:
                blk = self._mailbox.popleft() if self._mailbox else None
            if blk is not None:
                yield blk
            elif self._eof or self._closed:
                return
            # else: spurious permit (a drop raced a consumer claim); retry

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def rtl_tcp_source(url: str, params: RtlTcpParams, block: int,
                   n_buffers: int = 8) -> RtlTcpSource:
    """Open ``rtl_tcp://host:port``, configure, return the block source —
    the ``sdrStream`` analog (RTLSDRStream.hs:54-68)."""
    host, port = parse_rtl_tcp_url(url)
    return RtlTcpSource(host, port, params, block, n_buffers)
