"""Models of the port: NHWC at their public forwards, reference state-dict names."""
