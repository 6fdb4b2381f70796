"""The port's docs lane: execute every ```python torch fence of README.md,
docs/*.md and docs/torch/*.md on the CPU, so the port's documentation
cannot rot.

The counterpart of tests/test_docs_examples.py (whose regex,
``^```python[ \\t]*\\n``, does not match these fences, so the reference lane
is unchanged). Each snippet runs via exec() against a COPY of one seeded
namespace with the names the reference's docs are written against —
``mlp``/``calib``/``mlp_banks``, ``peg_rnn``, ``ae_banks``, inputs
``x``/``x_stats``/``x_seq``/``feats``/``bursts`` — built by the port on
the CPU at throwaway sizes, plus ``torch`` and ``device = "cpu"`` (the
name the port's snippets pass as ``device=``; on the card it is
``"cuda"``).
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import re
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DOC_FILES = [ROOT / "README.md", *sorted((ROOT / "docs").glob("*.md")),
             *sorted((ROOT / "docs" / "torch").glob("*.md"))]

_FENCE = re.compile(r"^```python torch[ \t]*\n(.*?)^```[ \t]*$", re.M | re.S)


def _snippets():
    """Every ```python torch fence, id'd by file + first code line number."""
    out = []
    for path in DOC_FILES:
        text = path.read_text()
        for m in _FENCE.finditer(text):
            first_line = text[: m.start()].count("\n") + 2
            out.append(pytest.param(str(path), m.group(1),
                                    id=f"{path.relative_to(ROOT)}:{first_line}"))
    return out


_PARAMS = _snippets()


@pytest.mark.docs
def test_port_docs_have_snippets():
    """At least the port's counterparts of the reference's 13 snippets plus
    the README's serving block, from both files."""
    files = {p.id.rsplit(":", 1)[0] for p in _PARAMS}
    assert {"README.md", "docs/torch/API.md"} <= files, files
    assert len(_PARAMS) >= 14, [p.id for p in _PARAMS]


@pytest.fixture(scope="module")
def docs_ns():
    """The namespace the port's snippets are written against, built on the
    CPU. ``pegasusify_mlp`` is re-exported with ``depth=3,
    refine_steps=0`` so snippets that lower a model inline stay cheap."""
    from repro_torch.data.synthetic_traffic import make_dataset
    from repro_torch.nets.autoencoder import anomaly_features, pegasusify_ae, train_autoencoder
    from repro_torch.nets.mlp import pegasusify_mlp, train_mlp
    from repro_torch.nets.rnn import pegasusify_rnn, train_rnn

    device = "cpu"
    ds = make_dataset("peerrush", flows_per_class=48)
    calib = ds.train["stats"].astype(np.float32)
    mlp = train_mlp(ds.train["stats"], ds.train["label"], ds.num_classes, steps=5,
                    device=device)
    peg_mlp = partial(pegasusify_mlp, depth=3, refine_steps=0)
    rnn = train_rnn(ds.train["seq"], ds.train["label"], ds.num_classes, steps=5,
                    device=device)
    flat = ds.train["seq"].reshape(len(ds.train["label"]), -1)
    ae = train_autoencoder(flat, steps=5, device=device)

    x_stats = torch.as_tensor(ds.test["stats"][:16], dtype=torch.float32)
    return {
        "np": np,
        "torch": torch,
        "device": device,
        "mlp": mlp,
        "calib": calib,
        "x": x_stats,
        "pegasusify_mlp": peg_mlp,
        "mlp_banks": peg_mlp(mlp, calib),
        "peg_rnn": pegasusify_rnn(rnn, ds.train["seq"], depth=4),
        "ae_banks": pegasusify_ae(ae, flat.astype(np.float32), depth=4),
        "x_stats": x_stats,
        "x_seq": torch.as_tensor(ds.test["seq"][:16]),
        "feats": anomaly_features(ds.test["seq"][:16].reshape(16, -1)),
        "bursts": [x_stats[:n] for n in (5, 9, 16)],
    }


@pytest.mark.docs
@pytest.mark.parametrize(("path", "code"), _PARAMS)
def test_port_docs_snippet_executes(path, code, docs_ns):
    exec(compile(code, path, "exec"), dict(docs_ns))
