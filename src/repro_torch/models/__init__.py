from . import config, layers, model, ssm
from .config import ArchConfig, SHAPES, ShapeConfig
