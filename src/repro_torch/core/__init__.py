"""Cell model, time surfaces and STCF configuration."""
