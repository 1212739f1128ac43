"""Model configurations: the reference's ``configs/`` copied as they are
(published widths, ``reduced()`` smoke variants), for the port's model zoo."""
