"""nerf"""
