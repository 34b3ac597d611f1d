"""JSON encoder for numpy scalars and arrays, and tensors
(nerfsafetyvalidation_tpu/validation/utils/numpy_encoder.py; reference
validation/utils/NumpyEncoder.py)."""

import json

import numpy as np


class NumpyEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, (np.floating,)):
            return float(obj)
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if hasattr(obj, "tolist"):  # tensors
            return obj.tolist()
        return json.JSONEncoder.default(self, obj)
