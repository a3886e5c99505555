"""Host utilities of the port: IO dispatch (:mod:`.img_util`) and retry
with backoff for cloud stores (:mod:`.retry`)."""
