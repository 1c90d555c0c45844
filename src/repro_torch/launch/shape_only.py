"""The kernels' shape-only path in the dry run (``launch.dryrun``): while
a step analysis (``step_analysis.StepAnalysis``) is active, it swaps the
entry points of K7 (``kernels.flash_attention.flash_attention`` and
``attention_backward``) and K8 (``kernels.mamba_scan.selective_scan``
and ``selective_scan_backward``) for the wrappers ``entries`` gives.  The
kernels' modules know nothing of this.

A fake tensor (``FakeTensorMode``) has a shape and no data, so no kernel
can launch on it, and K8's plain version, which steps through the
sequence one time step at a time, would run 32,768 fake operations a
layer.  On fake inputs the wrappers therefore return empty outputs of
the right shapes and dtypes (``torch.empty`` under the fake mode) and
report to their analysis the dot FLOPs and bytes that the plain versions
would count, as the reference's dry run lowers its jnp model path:

  * K7: the plain forward (``ref.attention_ref``) and backward
    (``flash_attention.attention_backward``) are a fixed handful of
    operations at any length, so they run once on the fake inputs with
    the analysis quiet, under one of their own (the analysis's memory
    tracker never sees their (S, Skv) scores);
  * K8: the plain forward is linear in S (every time step runs the same
    operations), so its counts at S are c(1) + (S - 1) (c(2) - c(1)),
    each c measured on the first steps of the fake inputs.  The plain
    backward runs in chunks of C steps: a last chunk of r steps costs
    c(r) alone (measured for r <= 3, linear beyond: at one step torch's
    einsum takes another path), and each whole chunk before it adds
    c(C + 2) - c(2).

Real tensors, and everything run while the analysis is quiet, go to the
swapped-out function itself.  Measurements are cached by the inputs'
shapes and dtypes (every layer of a model repeats them).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_cache: Dict[tuple, Tuple[float, float, float]] = {}


def _is_fake(args) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in args)


def entries(analysis):
    """[(module, name, wrapper)]: the four kernel entry points and the
    wrappers that take the shape-only path on fake inputs, reporting to
    ``analysis``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    out = []
    for mod, name, shape in ((fa, "flash_attention", attention),
                             (fa, "attention_backward", attention_backward),
                             (ms, "selective_scan", selective_scan),
                             (ms, "selective_scan_backward",
                              selective_scan_backward)):
        orig = getattr(mod, name)
        site = f"{mod.__name__[len('repro_torch.'):]}.{name}"
        out.append((mod, name, _wrap(analysis, orig, shape, site)))
    return out


def _wrap(analysis, orig, shape, site):
    def run(*args, **kwargs):
        if analysis.quieted or not _is_fake(args):
            return orig(*args, **kwargs)
        return shape(_Sink(analysis, site), orig, *args, **kwargs)
    # one launch counter: the kernel bumps ``<name>.launches``, which
    # names this wrapper while it is swapped in
    run.__dict__ = orig.__dict__
    run.__name__, run.__doc__ = orig.__name__, orig.__doc__
    return run


class _Sink:
    """What a shape-only path reports to: its analysis, under the name of
    the kernel entry point it stands for."""

    def __init__(self, analysis, site: str):
        self.analysis, self.site = analysis, site

    def report(self, key, counts) -> None:
        if key not in _cache:
            _cache[key] = counts()
        self.analysis.report(*_cache[key], site=self.site)

    def empty(self, *specs):
        """Empty tensors of (shape, dtype, device) ``specs``: the kernel's
        outputs, which the analysis holds in memory but counts no traffic
        for (the plain version's counts include writing them)."""
        with self.analysis.quiet():
            out = tuple(torch.empty(shape, dtype=dtype, device=device)
                        for shape, dtype, device in specs)
        self.analysis.track(out)
        return out

    def measure(self, fn, *args) -> Tuple[float, float, float]:
        """(dot FLOPs, traffic bytes, flop-registry FLOPs) that
        ``fn(*args)`` counts under a step analysis of its own; this one
        does not see it."""
        from repro_torch.launch.step_analysis import StepAnalysis
        with self.analysis.quiet(), StepAnalysis(shape_only=False) as inner:
            fn(*args)
        s = inner.stats
        return s.dot_flops, s.traffic_bytes, s.flops


def _key(*parts) -> tuple:
    return tuple((tuple(p.shape), p.dtype, tuple(p.stride()))
                 if isinstance(p, torch.Tensor) else p for p in parts)


def _combine(*terms):
    """Sum of (weight, counts) terms, element by element."""
    return tuple(sum(w * c[i] for w, c in terms) for i in range(3))


# ------------------------------- K7 ------------------------------------ #
def attention(sink, orig, q, k, v, *, causal=True, window=None,
              attn_softcap=None, q_positions=None, kv_positions=None):
    from repro_torch.kernels.ref import attention_ref
    opts = dict(causal=causal, window=window, attn_softcap=attn_softcap,
                q_positions=q_positions, kv_positions=kv_positions)
    sink.report(_key("fa", q, k, v, *opts.values()),
                lambda: sink.measure(lambda: attention_ref(q, k, v, **opts)))
    return sink.empty((q.shape, q.dtype, q.device))[0]


def attention_backward(sink, orig, q, k, v, out, dout, *, causal=True,
                       window=None, attn_softcap=None, q_positions=None,
                       kv_positions=None):
    opts = dict(causal=causal, window=window, attn_softcap=attn_softcap,
                q_positions=q_positions, kv_positions=kv_positions)
    sink.report(_key("fa_bwd", q, k, v, out, dout, *opts.values()),
                lambda: sink.measure(lambda: orig(q, k, v, out, dout,
                                                  **opts)))
    return sink.empty(*((t.shape, t.dtype, t.device) for t in (q, k, v)))


# ------------------------------- K8 ------------------------------------ #
def _first(n, u, dt, Bmat, Cmat):
    return (u[:, :n], dt[:, :n], Bmat[:, :n], Cmat[:, :n])


def selective_scan(sink, orig, u, dt, A, Bmat, Cmat, h0=None):
    from repro_torch.kernels.ref import selective_scan_ref
    Bsz, S, D = u.shape
    N = A.shape[1]

    def counts():
        def at(n):
            uu, dd, bb, cc = _first(n, u, dt, Bmat, Cmat)
            return sink.measure(selective_scan_ref, uu, dd, A, bb, cc, h0)
        if S <= 1:
            return at(S)
        c1 = at(1)
        return _combine((1, c1), (S - 1, at(2)), (-(S - 1), c1))

    sink.report(_key("scan", u, dt, A, Bmat, Cmat, h0), counts)
    return sink.empty(((Bsz, S, D), torch.float32, u.device),
                      ((Bsz, D, N), torch.float32, u.device))


def selective_scan_backward(sink, orig, u, dt, A, Bmat, Cmat, h0, dy,
                            dh_last, chunk: int = 256):
    Bsz, S, D = u.shape

    def at(n):
        uu, dd, bb, cc = _first(n, u, dt, Bmat, Cmat)
        return sink.measure(orig, uu, dd, A, bb, cc, h0, dy[:, :n],
                            dh_last, chunk)

    def counts():
        C = max(1, min(chunk, S)) if S else 1
        n = max(1, -(-S // C))
        r = S - (n - 1) * C                   # the last chunk's length
        if r <= 3:
            last = at(r)
        else:
            c2, c3 = at(2), at(3)
            last = _combine((1, c2), (r - 2, c3), (-(r - 2), c2))
        if n == 1:
            return last
        ahead = _combine((1, at(C + 2)), (-1, at(2))) if C > 1 else \
            _combine((1, at(2)), (-1, at(1)))
        return _combine((1, last), (n - 1, ahead))

    sink.report(_key("scan_bwd", u, dt, A, Bmat, Cmat, h0, dy, dh_last,
                     chunk), counts)
    grads = (u, dt, A, Bmat, Cmat) + (() if h0 is None else (h0,))
    out = sink.empty(*((t.shape, t.dtype, t.device) for t in grads))
    return out if h0 is not None else out + (None,)
