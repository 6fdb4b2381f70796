"""The paper's dataplane baselines (§2): N3IC, BoS and Leo."""
