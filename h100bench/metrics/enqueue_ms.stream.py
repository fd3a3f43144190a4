"""Host ms for the server's call to return a batch, its mean over the window."""

from h100bench import readers


def read(r):
    return readers.enqueue_ms(r)
