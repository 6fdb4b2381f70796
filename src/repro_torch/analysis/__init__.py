"""Runtime concurrency checks of the port (:mod:`.sanitizer`)."""
