"""The LM families in torch: layers, the decoder stack, the
encoder-decoder and the family-dispatching facade (counterparts of
``repro.models``)."""
