"""The paper's network: MiRU cell and readout, k-WTA, chip-step meter."""
