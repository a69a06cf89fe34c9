"""Mixed-signal numerics: the WBS quantizer and the output ADC."""
