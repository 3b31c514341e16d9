"""Memory layer: the int8 codec math and the tier errors the paged pool
needs.  The tier stack and the byte codecs wait for the resilient-serving
slice."""
