"""The dense LM family in torch: layers, the decoder stack and the
family-dispatching facade (counterparts of ``repro.models``)."""
