"""Host utilities of the port: IO dispatch (:mod:`.img_util`), retry
with backoff for cloud stores (:mod:`.retry`) and directory helpers
(:mod:`.util`)."""
