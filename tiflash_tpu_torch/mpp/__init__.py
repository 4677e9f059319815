"""The query service (``mpp/service.py``).  The distributed runner of the
reference's ``mpp`` package comes with the distribution slice of the
port."""
