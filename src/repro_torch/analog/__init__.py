"""Mixed-signal hardware-like model of the M2RU accelerator.

- crossbar:   conductance-pair weight mapping + device non-idealities.
- wbs:        weighted-bit-streaming numerical model (eqs. 11-19).
- adc:        the mid-rise output ADC.
- endurance:  per-device write counting, CDF, lifespan projection (Fig. 5b).
- costmodel:  cycle/power analytical model (Fig. 5c/5d, Table I).
"""
