"""Seeded PG004 violations for the port's lint — fixture, parsed by tests,
never imported. Plan forwards (by name) and CUDA graph capture bodies."""

import threading
import time

import numpy as np
import torch

_TRACE_LOCK = threading.Lock()


class _Counters:
    total = 0


COUNTERS = _Counters()
SEEN = []


def forward(apply, state, x):
    t0 = time.time()  # VIOLATION PG004
    print("forward", t0)  # VIOLATION PG004
    COUNTERS.total += 1  # VIOLATION PG004
    SEEN.append(x)  # VIOLATION PG004
    with _TRACE_LOCK:  # VIOLATION PG004
        pass
    noise = np.random.rand()  # VIOLATION PG004
    if x.max().item() > 0:  # VIOLATION PG004
        x = x.cpu()  # VIOLATION PG004
    bias = torch.tensor(state["bias"], device=x.device)  # VIOLATION PG004
    scale = torch.as_tensor([1.0, 2.0], device=x.device)  # VIOLATION PG004
    h = apply(state["steps"][0], x) + bias * scale + noise
    rows = []
    rows.append(h)               # a local list: fine
    return torch.as_tensor(h)    # a tensor, not Python data: fine


def capture(graph, plan, static):
    with torch.cuda.graph(graph):
        out = plan(static)
        ids = torch.tensor([0, 1], device=out.device)  # VIOLATION PG004
        total = out.sum().item()  # VIOLATION PG004
    return out[ids], total, out.cpu()    # after the capture: fine
