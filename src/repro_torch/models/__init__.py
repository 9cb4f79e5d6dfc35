"""Dense decoder LM: layers, attention, transformer stack, model."""
