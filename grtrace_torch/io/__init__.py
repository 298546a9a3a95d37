from . import scene, textures
