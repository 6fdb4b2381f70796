"""Flows per dispatched micro-batch, over the window before the traced
sub-window: the server's ``flows_served`` over its ``batches_dispatched``
(``stats()["serving"]``)."""

from bench.metrics_util import flows_per_batch as read  # noqa: F401
