"""Scene description: geometry, materials, textures, camera, environment."""
