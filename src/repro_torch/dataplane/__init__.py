"""The dataplane target (port of the JAX package's ``dataplane/``): lower
pegasusified banks to an integer MAT pipeline (:mod:`.compile`), run it
per packet or batched on a device (:mod:`.mat`), and charge it against a
Tofino-2-like switch budget (:mod:`.resources`, :mod:`.crc`)."""
