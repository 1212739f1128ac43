"""Collection guard for the repo root.

`scratch_checkout/` holds unpacked copies of whole checkouts (see
.gitignore), each with its own `tests/` and `bench/tests/`. Collected
beside the repo's own tests, their files share module basenames with
ours and every one of them fails to import, so pytest leaves them out.
"""

collect_ignore = ["scratch_checkout"]
