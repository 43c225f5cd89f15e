"""``paddle.framework`` as far as it is ported: ``io`` (``save`` /
``load``)."""
