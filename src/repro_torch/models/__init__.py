"""The LM stack (port of ``repro.models``): layers, attention, MoE,
recurrent blocks, the composable transformer and its Pegasus FFN."""
