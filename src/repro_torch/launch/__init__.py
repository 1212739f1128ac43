"""Process launch for the port (the reference's ``launch/``): the users
mesh of the SPMD federation (``mesh.py``)."""
