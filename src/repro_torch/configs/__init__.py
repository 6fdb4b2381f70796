"""Architecture configs of the LM stack (port of ``repro.configs``)."""
