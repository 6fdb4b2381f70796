"""Tiny in-tree model zoo for ``python -m repro_torch.analysis plan`` (port
of the JAX package's ``analysis/zoo.py``).

One builder per model family (MLP / RNN / CNN / CNN-L / AE), trained on the
synthetic traffic dataset at fixture scale: the audit needs real bank
geometry and real q8 tables, not an accurate classifier. Kept out of
``repro_torch.analysis.__init__``: the lint and the sanitizer need no nets.
"""

from __future__ import annotations

import functools

FAMILY_NAMES = ("mlp", "rnn", "cnn", "cnn_l", "ae")


@functools.lru_cache(maxsize=None)
def _dataset(flows: int):
    from repro_torch.data.synthetic_traffic import make_dataset

    return make_dataset("peerrush", flows_per_class=flows)


def build_family(family: str, *, flows: int = 48, steps: int = 5,
                 device="cuda"):
    """Train + pegasusify one model family at fixture scale on ``device``
    (the GPU by default); returns the model object ``build_plan`` accepts."""
    import numpy as np

    ds = _dataset(flows)
    if family == "mlp":
        from repro_torch.nets.mlp import pegasusify_mlp, train_mlp

        m = train_mlp(ds.train["stats"], ds.train["label"], ds.num_classes,
                      steps=steps, device=device)
        return pegasusify_mlp(m, ds.train["stats"].astype(np.float32),
                              depth=3, refine_steps=0)
    if family == "rnn":
        from repro_torch.nets.rnn import pegasusify_rnn, train_rnn

        m = train_rnn(ds.train["seq"], ds.train["label"], ds.num_classes,
                      steps=steps, device=device)
        return pegasusify_rnn(m, ds.train["seq"], depth=4)
    if family == "cnn":
        from repro_torch.nets.cnn import pegasusify_cnn, train_cnn

        m = train_cnn(ds.train["seq"], ds.train["label"], ds.num_classes,
                      size="B", steps=steps, device=device)
        return pegasusify_cnn(m, ds.train["seq"], depth=5)
    if family == "cnn_l":
        from repro_torch.nets.cnn import pegasusify_cnn_l, train_cnn_l

        m = train_cnn_l(ds.train["seq"], ds.train["bytes"],
                        ds.train["label"], ds.num_classes, steps=steps,
                        device=device)
        return pegasusify_cnn_l(m, ds.train["seq"], ds.train["bytes"],
                                enc_depth=4, index_bits=3)
    if family == "ae":
        from repro_torch.nets.autoencoder import pegasusify_ae, train_autoencoder

        x = ds.train["seq"].reshape(len(ds.train["label"]), -1)
        m = train_autoencoder(x, steps=steps, device=device)
        return pegasusify_ae(m, x.astype(np.float32), depth=4)
    raise ValueError(f"unknown family {family!r}; know {FAMILY_NAMES}")
