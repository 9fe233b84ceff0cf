"""Device ms a traced step in NCCL kernels (the collectives between the
cards: the gradients' all-reduce, the 'seq' axis' halos, gathers and sums)
while no other kernel runs: the union of the NCCL kernels' intervals less
the union of every other kernel's. None without an NCCL kernel."""


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _less(spans, cover):
    """The parts of the disjoint sorted ``spans`` that ``cover`` (disjoint,
    sorted) leaves bare, in total."""
    total, j = 0.0, 0
    for s, e in spans:
        while j < len(cover) and cover[j][1] <= s:
            j += 1
        cur, k = s, j
        while k < len(cover) and cover[k][0] < e:
            total += max(0.0, cover[k][0] - cur)
            cur = max(cur, cover[k][1])
            k += 1
        total += max(0.0, e - cur)
    return total


def read(ctx):
    t0, t1 = ctx.trace.window
    dev = [(n, max(s, t0), min(e, t1)) for n, s, e in ctx.trace.device if min(e, t1) > max(s, t0)]
    nccl = _union([(s, e) for n, s, e in dev if "nccl" in n.lower()])
    if not nccl or not ctx.n_requests:
        return None
    other = _union([(s, e) for n, s, e in dev if "nccl" not in n.lower()])
    exposed = _less(nccl, other)
    ctx.log(f"allreduce_exposed_ms_per_step: NCCL {sum(e - s for s, e in nccl) / 1e3:.3f} ms, "
            f"exposed {exposed / 1e3:.3f} ms over {ctx.n_requests} steps")
    return exposed / 1e3 / ctx.n_requests
