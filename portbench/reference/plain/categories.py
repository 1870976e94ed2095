"""Object flag <-> category / prompt lookup tables.

Equivalent of the reference's getID/getCategory/getPrompt tables
(reference: utils/dataUtils.py:583-647).  The redwood evaluation set is 13
partial/GT pairs under data/*.ply; ten have category names.
"""

from __future__ import annotations

_CATEGORY = {
    "01184": "Wheelie Bin",
    "05117": "chair",
    "05452": "armchair",
    "06127": "Plant vases",
    "06145": "table",
    "06188": "vespa",
    "06830": "Kid tricycle",
    "07089": "sofa",
    "07136": "sofa",
    "07306": "trash can",
    "09639": "swivel chair",
    "01373": "chair",
    "06188b": "vespa",
}

_ID = {v: k for k, v in _CATEGORY.items()}
_ID.update({
    "car": "car",
    "airplane": "airplane",
    "Square table_base": "Square table_base",
})

_PROMPT = {
    "car": "car",
    "Wheelie Bin": "a green Wheelie Bin",
    "chair": "chair",
    "armchair": "armchair",
    "Plant vases": "plant in a large vase",
    "table": "one leg square table_base",
    "table_base": "one leg square table_base",
    "vespa": "vespa",
    "Kid tricycle": "Children's tricycle with handle",
    "sofa": "sofa",
    "trash can": "a office trash can",
    "swivel chair": "swivel chair with brown legs",
    "airplane": "airplane",
    "Square table_base": "Square table_base",
    # ShapeNet synset ids (PCN categories)
    "02691156": "airplane",
    "02933112": "cabinet",
    "02958343": "car",
    "03001627": "chair",
    "03636649": "lamp",
    "04256520": "sofa",
    "04379243": "table_base",
    "04530566": "vessel",
    # Waymo LiDAR categories
    "CAR": "car",
    "PED": "pedestrian",
    "OTHER": "object",
}


def get_category(flag: str) -> str:
    """Category name for an object flag; falls back to the flag itself."""
    if flag in _CATEGORY:
        return _CATEGORY[flag]
    for prefix in ("CAR", "PED", "OTHER"):
        if flag.startswith(prefix):
            return _PROMPT[prefix]
    return flag


def get_id(category: str) -> str:
    return _ID.get(category, category)


def get_prompt(flag_or_category: str) -> str:
    cat = get_category(flag_or_category)
    return _PROMPT.get(cat, cat)


REDWOOD_FLAGS = [
    "01184", "01373", "05117", "05452", "06127", "06145", "06188",
    "06830", "07089", "07136", "07306", "09639", "09868",
]
