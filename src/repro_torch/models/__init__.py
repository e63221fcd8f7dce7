"""Models of the port: the decoder-only families and the encoder-decoder
family (``model.build_model`` dispatches)."""
