"""Pure-numpy oracle implementations of the reference kernel semantics.

These play the role the reference's ``filterHighLevel`` /
``decimateHighLevel`` / ``resampleHighLevel`` fallbacks play in its
differential test suite (tests/TestSuite.hs): an independent, obviously-
correct implementation every fast path must agree with.  Each function is a
direct transliteration of the semantics documented in SURVEY.md §2.2 —
*not* of any reference source file.
"""

import numpy as np


def filter_oracle(taps, x, num):
    """y[i] = sum_j taps[j] * x[i+j]  (correlation orientation)."""
    taps = np.asarray(taps)
    x = np.asarray(x)
    K = len(taps)
    return np.stack([(x[i:i + K] * taps).sum() for i in range(num)])


def decimate_oracle(taps, factor, x, num):
    """y[i] = sum_j taps[j] * x[i*factor + j]."""
    taps = np.asarray(taps)
    x = np.asarray(x)
    K = len(taps)
    return np.stack([(x[i * factor:i * factor + K] * taps).sum()
                     for i in range(num)])


def resample_oracle(taps, interpolation, decimation, x, offset, num):
    """The reference's sequential phase recurrence, verbatim semantics:

    per output: dot(x[inputOffset:], taps[filterOffset::I]) then
    (q, r) = divmod(D - filterOffset - 1, I); inputOffset += q + 1;
    filterOffset = I - 1 - r.  Returns (y, end_offset).
    """
    taps = np.asarray(taps)
    x = np.asarray(x)
    out = []
    fo = offset
    io = 0
    for _ in range(num):
        sub = taps[fo::interpolation]
        seg = x[io:io + len(sub)]
        out.append((seg * sub[: len(seg)]).sum())
        q, r = divmod(decimation - fo - 1, interpolation)
        io += q + 1
        fo = interpolation - 1 - r
    return np.stack(out) if out else np.zeros(0, x.dtype), fo


def fm_demod_oracle(x, last=0j):
    out = np.empty(len(x), dtype=np.float64)
    for i, s in enumerate(x):
        out[i] = np.angle(s * np.conj(last))
        last = s
    return out, last


def dc_blocker_oracle(x, last_sample=0.0, last_output=0.0, alpha=0.997):
    y = np.empty(len(x), dtype=np.float64)
    ls, lo = last_sample, last_output
    for i, s in enumerate(x):
        lo = s - ls + alpha * lo
        ls = s
        y[i] = lo
    return y, (ls, lo)


def agc_oracle(x, mu, reference, state=1.0):
    y = np.empty(len(x), dtype=np.complex128)
    g = state
    for i, s in enumerate(x):
        c = s * g
        y[i] = c
        g = g + mu * (reference - abs(c))
    return y, g


# ---------------------------------------------------------------------------
# Whole-chain references (float64 numpy, vectorized over the stream).  The
# streaming chains start from zero history, so each is the one-shot
# formula over the stream with that many zero samples in front.
# ---------------------------------------------------------------------------

def u8_to_complex(raw):
    raw = np.asarray(raw, dtype=np.float64)
    return (raw[..., 0::2] - 128.0) / 128.0 + 1j * (raw[..., 1::2] - 128.0) / 128.0


def decimate_stream(taps, factor, x):
    """Streamed decimator output: history of K - factor zeros."""
    taps = np.asarray(taps, np.float64)
    K = len(taps)
    xp = np.concatenate([np.zeros(max(0, K - factor), x.dtype), x])
    num = len(x) // factor
    y = np.zeros(num, np.result_type(x.dtype, np.float64))
    for k in range(K):
        y += taps[k] * xp[k: k + num * factor: factor]
    return y


def filter_stream(taps, x):
    return decimate_stream(taps, 1, x)


def resample_stream(taps, interpolation, decimation, x, block):
    """Streamed rational resampler (offset 0) over blocks of ``block``
    inputs: y[m] = sum_k taps[o_m + k*I] * X[i_m + k] with the closed-form
    positions and X the stream behind the history the streaming op keeps
    (the furthest any block's last output reads past its block)."""
    taps = np.asarray(taps, np.float64)
    I, D, K = interpolation, decimation, len(taps)
    m = np.arange(block * I // D, dtype=np.int64)
    t = m * D
    o = (-t) % I
    i = (t + o) // I
    H = max(0, int((i + -(-(K - o) // I) - 1).max()) - block + 1)
    X = np.concatenate([np.zeros(H, x.dtype), x])
    num = len(x) * I // D
    m = np.arange(num, dtype=np.int64)
    t = m * D
    o = (-t) % I
    i = (t + o) // I
    y = np.zeros(num, np.result_type(x.dtype, np.float64))
    for k in range(-(-K // I)):
        tap = np.where(o + k * I < K, taps[np.minimum(o + k * I, K - 1)], 0.0)
        y += tap * X[np.minimum(i + k, len(X) - 1)]   # tap 0 past the end
    return y


def fm_chain_oracle(raw, rf, ars, afl, volume, block):
    """u8 IQ -> decimate 8 -> FM demod -> 3/10 resample -> audio FIR ->
    volume (the mono broadcast chain), for a stream of u8 ``block``s."""
    x = decimate_stream(rf, 8, u8_to_complex(raw))
    y = np.angle(x * np.conj(np.concatenate([[0j], x[:-1]])))
    y = resample_stream(ars, 3, 10, y, block // 16)
    return volume * filter_stream(afl, y)


def am_chain_oracle(raw, if_freq, chan, decim, mu, volume, alpha=0.997):
    """u8 IQ -> mix by -if_freq -> decimate -> AGC -> envelope -> DC
    blocker -> volume (the AM chain)."""
    x = u8_to_complex(raw)
    n = np.arange(len(x), dtype=np.float64)
    x = x * np.exp(-2j * np.pi * np.mod(if_freq * n, 1.0))
    x = decimate_stream(chan, decim, x)
    y, _ = agc_oracle(x, mu, 1.0)
    y, _ = dc_blocker_oracle(np.abs(y), alpha=alpha)
    return volume * y


def waterfall_oracle(raw, window, hop):
    """|fftshift(fft(frame * window))| rows, frames every ``hop`` samples
    behind a history of size - hop zeros."""
    x = u8_to_complex(raw)
    size = len(window)
    X = np.concatenate([np.zeros(size - hop, x.dtype), x])
    frames = len(x) // hop
    idx = np.arange(frames)[:, None] * hop + np.arange(size)[None, :]
    F = np.fft.fft(X[idx] * np.asarray(window, np.float64), axis=-1)
    return np.abs(np.fft.fftshift(F, axes=-1))
