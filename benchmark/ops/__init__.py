"""One module an operation a traffic mix can name (``"op"``): its set-up,
its request and its check against the reference."""
